"""The port's packed shards (``dataset/shardfile.py``), the ImageNet shard
generator (``dataset/imagenet_tools.py``), the folder factories
``DataSet.image_folder`` / ``DataSet.seq_file_folder`` and the
``Optimizer``'s routing predicate against the JAX package: the port's
shards equal the JAX bytes, each package reads the other's, bad and cut
shards raise, ``ShardFolder``'s shuffles draw what the JAX one draws after
``set_seed``, and a streaming root with ``distributed=True`` routes to the
``DistriOptimizer`` in both packages.  All host code, compared exactly."""
import os
import struct

import numpy as np
import pytest

import bigdl_tpu.dataset.seqfile as jax_seqfile
import bigdl_tpu.dataset.shardfile as jax_shardfile
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import imagenet_tools as jax_tools
from bigdl_tpu.dataset.image import HFlip as JaxHFlip
from bigdl_tpu.optim.optimizer import \
    is_distributed_dataset as jax_is_distributed
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.dataset import DataSet, HFlip, seqfile, shardfile
from bigdl_tpu_torch.dataset import imagenet_tools
from bigdl_tpu_torch.dataset.dataset import is_distributed_dataset
from bigdl_tpu_torch.dataset.sample import ByteRecord


def _records(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(f"{rs.randint(1, 5)}", rs.bytes(rs.randint(1, 40)))
            for _ in range(n)]


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def _read(mod, paths):
    return [(r.label, r.data) for p in paths for r in mod.read_shard(p)]


@pytest.mark.parametrize("n_shards", [1, 3])
def test_shards_equal_jax_bytes_and_each_reads_the_other(tmp_path, n_shards):
    recs = _records(11)
    jp = jax_shardfile.write_shards(iter(recs), str(tmp_path / "j"),
                                    n_shards, prefix="p")
    pp = shardfile.write_shards(iter(recs), str(tmp_path / "t"), n_shards,
                                prefix="p")
    assert [os.path.basename(p) for p in pp] == \
        [os.path.basename(p) for p in jp] == \
        [f"p-{i:05d}.bdts" for i in range(n_shards)]
    assert _bytes(pp) == _bytes(jp)
    want = _read(jax_shardfile, jp)
    assert _read(shardfile, jp) == want == _read(jax_shardfile, pp)
    assert sorted(want) == sorted((float(k), d) for k, d in recs)
    one = str(tmp_path / "one.bdts")
    assert shardfile.write_shard(iter(recs), one) == 11
    jax_shardfile.write_shard(iter(recs), str(tmp_path / "jone.bdts"))
    assert _bytes([one]) == _bytes([str(tmp_path / "jone.bdts")])


def test_bad_and_cut_shards_raise_and_a_failed_write_leaves_nothing(
        tmp_path):
    path = str(tmp_path / "a.bdts")
    shardfile.write_shard(iter(_records(3)), path)
    raw = open(path, "rb").read()
    bad = tmp_path / "bad.bdts"
    bad.write_bytes(b"XXXX" + raw[4:])
    # the JAX reader asserts the magic; the port raises ValueError (an
    # assert vanishes under python -O)
    with pytest.raises(AssertionError, match="bad shard magic"):
        list(jax_shardfile.read_shard(str(bad)))
    with pytest.raises(ValueError, match="bad shard magic"):
        list(shardfile.read_shard(str(bad)))
    cut = tmp_path / "cut.bdts"
    cut.write_bytes(raw[:-3])
    with pytest.raises(ValueError, match="truncated at record 2"):
        list(shardfile.read_shard(str(cut)))

    def failing():
        yield "1", b"x"
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError):
        shardfile.write_shards(failing(), str(tmp_path / "f"), 2)
    assert os.listdir(tmp_path / "f") == []
    with pytest.raises(ValueError, match="local paths only"):
        shardfile.write_shard(iter([]), "gs://bucket/x.bdts")


def _png_folder(root, n_classes=3, per_class=3):
    rs = np.random.RandomState(1)
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"n{c:03d}"))
        for i in range(per_class):
            with open(os.path.join(root, f"n{c:03d}", f"{i}.png"), "wb") as f:
                f.write(rs.bytes(rs.randint(5, 30)))
    # an empty class folder counts as a class and holds no record
    os.makedirs(os.path.join(root, "n999"))
    with open(os.path.join(root, "stray.txt"), "w") as f:
        f.write("a file beside the class folders is no class")
    return root


@pytest.mark.parametrize("has_name", [False, True])
def test_imagenet_tools_writes_the_jax_shards(tmp_path, has_name, capsys):
    folder = _png_folder(str(tmp_path / "tree"))
    jp, jn = jax_tools.generate(folder, str(tmp_path / "j"), 2, has_name)
    pp, pn = imagenet_tools.generate(folder, str(tmp_path / "t"), 2,
                                     has_name)
    assert jn == pn == 4
    assert _bytes(pp) == _bytes(jp)
    labels = [r.label for p in pp for r in shardfile.read_shard(p)]
    if has_name:
        # the key stays text: "<label>:<file>"
        assert labels[0] == "1:0.png" and all(isinstance(l, str)
                                              for l in labels)
    else:
        assert sorted(set(labels)) == [1.0, 2.0, 3.0]
    imagenet_tools.main(["-f", folder, "-o", str(tmp_path / "cli"), "-p",
                         "3"] + (["--hasName"] if has_name else []))
    assert "wrote 3 shards for 4 classes" in capsys.readouterr().out


def test_shard_folder_passes_equal_jax(tmp_path):
    """A pass in order, and three training passes whose shard order each
    package shuffles from its stream: the port's ``ShardFolder(seed=s)``
    draws what the JAX one draws after ``set_seed(s)``."""
    shardfile.write_shards(iter(_records(13)), str(tmp_path), 4)
    jds = jax_shardfile.ShardFolder(str(tmp_path))
    pds = shardfile.ShardFolder(str(tmp_path), seed=6)
    assert pds.size() == jds.size() == 13
    once = lambda ds: [(r.label, r.data) for r in ds.data(train=False)]
    assert once(pds) == once(jds)
    set_seed(6)
    jit, pit = jds.data(train=True), pds.data(train=True)
    want = [next(jit) for _ in range(3 * 13)]
    got = [next(pit) for _ in range(3 * 13)]
    assert [(r.label, r.data) for r in got] == \
        [(r.label, r.data) for r in want]
    assert pds._order == jds._order
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .bdts shards"):
        shardfile.ShardFolder(str(tmp_path / "empty"))


def test_distributed_shard_folder_takes_whole_shards(tmp_path, monkeypatch):
    shardfile.write_shards(iter(_records(12)), str(tmp_path), 4)
    monkeypatch.setattr(shardfile, "_world_position", lambda: (1, 2))
    ds = shardfile.ShardFolder(str(tmp_path), distributed=True)
    assert ds.local_paths == ds.paths[1::2]
    assert len(list(ds.data(train=False))) == 6 and ds.size() == 12
    monkeypatch.setattr(shardfile, "_world_position", lambda: (5, 9))
    with pytest.raises(ValueError, match="got no shards"):
        shardfile.ShardFolder(str(tmp_path), distributed=True)


def test_streaming_roots_route_as_in_jax(tmp_path):
    """The repaired predicate: ``ShardFolder`` and ``SeqFileDataSet`` route
    on their ``distributed`` attribute, under a chain too, as in JAX."""
    shardfile.write_shards(iter(_records(4)), str(tmp_path / "s"), 2)
    w = seqfile.SequenceFileWriter(str(tmp_path / "q" / "p_0.seq"))
    w.append(b"1", seqfile.encode_image_value(np.zeros((1, 1, 3)), 1, 1))
    w.close()
    seen = []
    for dist in (False, True):
        jroots = [jax_shardfile.ShardFolder(str(tmp_path / "s"), dist),
                  jax_seqfile.SeqFileDataSet(str(tmp_path / "q"),
                                             distributed=dist)]
        proots = [shardfile.ShardFolder(str(tmp_path / "s"), dist),
                  seqfile.SeqFileDataSet(str(tmp_path / "q"),
                                         distributed=dist)]
        for j, p in zip(jroots, proots):
            got = [is_distributed_dataset(p),
                   is_distributed_dataset(p >> HFlip())]
            want = [jax_is_distributed(j), jax_is_distributed(j >> JaxHFlip())]
            assert got == want == [dist, dist]
            seen.append(got)
    assert is_distributed_dataset(DataSet.array([1, 2], distributed=True))
    assert not is_distributed_dataset(DataSet.array([1, 2]))
    assert len(seen) == 4


def test_folder_factories_equal_jax(tmp_path):
    folder = _png_folder(str(tmp_path / "tree"))
    want = list(JaxDataSet.image_folder(folder).data(train=False))
    got = list(DataSet.image_folder(folder).data(train=False))
    assert got == want and len(got) == 9 and got[0][1] == 1.0
    shardfile.write_shards(iter(_records(5)), str(tmp_path / "sh"), 2)
    ds = DataSet.seq_file_folder(str(tmp_path / "sh"), distributed=True)
    assert isinstance(ds, shardfile.ShardFolder) and ds.distributed
    with pytest.raises(ValueError, match="class_num is only supported"):
        DataSet.seq_file_folder(str(tmp_path / "sh"), class_num=2)
    w = seqfile.SequenceFileWriter(str(tmp_path / "sh" / "x_0.seq"))
    w.close()
    with pytest.raises(ValueError, match="holds BOTH"):
        DataSet.seq_file_folder(str(tmp_path / "sh"))
    with pytest.raises(ValueError, match="holds BOTH"):
        JaxDataSet.seq_file_folder(str(tmp_path / "sh"))


def test_a_hasname_key_stays_text_and_bytes_round_trip(tmp_path):
    recs = [("3:a.png", b"\x00\x01"), ("7", b"")]
    p = str(tmp_path / "n.bdts")
    shardfile.write_shard(iter(recs), p)
    got = list(shardfile.read_shard(p))
    assert [(r.label, r.data) for r in got] == [("3:a.png", b"\x00\x01"),
                                                (7.0, b"")]
    assert isinstance(got[0], ByteRecord)
    head = open(p, "rb").read()[:16]
    assert head[:4] == b"BDTS" and struct.unpack("<IQ", head[4:]) == (1, 2)
