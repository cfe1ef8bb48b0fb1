"""Local datasets (counterpart of bigdl_tpu/dataset/dataset.py; ref
dataset/DataSet.scala:47-294).

``DataSet.array(records, seed)`` holds the records in memory and loops
over them shuffled; ``ds >> transformer`` composes as DataSet.scala:74-88.
The shuffles draw from the dataset's own ``np.random.RandomState(seed)``:
the same draws, in the same order, as the JAX package's main-thread
``RNG.np_rng()`` after ``set_seed(seed)`` (an in-place ``shuffle`` of
the records at each epoch rollover, then one ``permutation`` as each
training pass starts), so the two packages see the same epoch order.
``DataSet.array(records, seed, distributed=True)`` is the sharded
dataset of a data-parallel run (``ShardedDataSet``): each rank holds the
strided shard ``records[r::N]`` and shuffles it from its own stream,
seeded alike on every rank.
``ds >> transformer`` hands that stream to every random (``stochastic``)
stage of the transformer that has none of its own, so the crops and
flips draw from it too, lazily, record by record, as the JAX pipeline
draws from ``RNG.np_rng()``.  While a prefetch producer runs, it owns
that stream (``utils.random.RandomGenerator.own_stream``).
``reshard`` (re-partitioning after a rank is lost) waits for the elastic
slice.
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer, stages
from bigdl_tpu_torch.utils.random import check_stream


def get_batch_size(total_batch: int, node_number: int) -> int:
    """The global batch over the nodes, which must divide it (ref
    dataset/Utils.scala:26-48)."""
    if total_batch % node_number != 0:
        raise ValueError(
            f"total batch size {total_batch} cannot be divided by node "
            f"number {node_number}; adjust the batch size (ref "
            f"dataset/Utils.scala:26)")
    return total_batch // node_number


class AbstractDataSet:
    """(ref DataSet.scala:47)"""

    def data(self, train: bool):
        """An iterator over records: ``train=True`` loops forever,
        shuffled; ``train=False`` makes one pass in order."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer):
        """``ds >> transformer`` == the reference's ``ds -> transformer``."""
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """Iterator-based local dataset (ref DataSet.scala:111)."""


class LocalArrayDataSet(LocalDataSet):
    """In-memory records with looped, shuffled iteration
    (ref DataSet.scala:128).

    The records stay where they are; ``order`` (indices into them) is the
    shuffled list the JAX dataset keeps by shuffling its records in
    place: an in-place shuffle of the indices draws what one of the
    records draws.  So the order is state a caller can save and put
    back (a checkpoint, or the prefetch undoing the shuffles of batches
    it never handed out)."""

    def __init__(self, data, seed: int = 1):
        self._data = list(data)
        self.order = np.arange(len(self._data))
        self.rng = np.random.RandomState(seed)

    def size(self):
        return len(self._data)

    def shuffle(self):
        check_stream(self.rng)
        self.rng.shuffle(self.order)
        return self

    def data(self, train: bool):
        if train:
            def looped():
                while True:
                    check_stream(self.rng)
                    for i in self.rng.permutation(len(self._data)):
                        yield self._data[self.order[i]]
            return looped()
        return (self._data[i] for i in self.order)


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer
        #: the random stream of the dataset at the chain's root, if any
        self.rng = getattr(base, "rng", None)
        for stage in stages(transformer):
            if getattr(stage, "stochastic", False) and stage.rng is None:
                stage.rng = self.rng

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train: bool):
        return self.transformer(self.base.data(train))


def _world_position():
    """(rank, world size): the process group's, else torchrun's
    variables, else (0, 1)."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return 0, 1


class ShardedDataSet(AbstractDataSet):
    """This rank's shard of a global dataset (the DistributedDataSet role,
    ref DataSet.scala:164 + CachedDistriDataSet:203; bigdl_tpu/dataset/
    dataset.py:102-172).

    The rank holds the strided shard ``data[shard_index::n_shards]`` (by
    default its rank of the world) and iterates it shuffled, as a
    ``LocalArrayDataSet`` over the shard: its stream is
    ``RandomState(seed)``, the same seed on every rank, as every JAX
    process is seeded by ``set_seed``.  ``size()`` is the global record
    count, what an epoch counts; ``shard_size()`` this rank's."""

    def __init__(self, data, n_shards: int = None, shard_index: int = None,
                 seed: int = 1):
        rank, world = _world_position()
        self.n_shards = world if n_shards is None else int(n_shards)
        self.shard_index = rank if shard_index is None else int(shard_index)
        if not 0 <= self.shard_index < self.n_shards:
            raise ValueError(f"shard {self.shard_index} of {self.n_shards}")
        data = list(data)
        self._global_size = len(data)
        self._all, self._seed = data, seed
        self._local = LocalArrayDataSet(
            data[self.shard_index::self.n_shards], seed)
        self.rng = self._local.rng

    def shard_by(self, n_shards: int, shard_index: int):
        """Hold shard ``shard_index`` of ``n_shards`` instead, its stream
        restarted from the seed: a fresh ``ShardedDataSet`` of that shard,
        its stream the same object (the chain's random stages keep
        drawing from it).  A sequence- or expert-parallel run shards by
        the ``data`` coordinate, so that the ranks of one data slice hold
        the same records."""
        if not 0 <= shard_index < n_shards:
            raise ValueError(f"shard {shard_index} of {n_shards}")
        self.n_shards, self.shard_index = int(n_shards), int(shard_index)
        local = LocalArrayDataSet(self._all[shard_index::n_shards])
        self.rng.seed(self._seed)
        local.rng = self.rng
        self._local = local
        return self

    @property
    def order(self):
        """The shuffled order of the shard's records (checkpoints carry
        it, as ``LocalArrayDataSet.order``)."""
        return self._local.order

    def size(self):
        return self._global_size

    def shard_size(self):
        return self._local.size()

    def shuffle(self):
        self._local.shuffle()
        return self

    def data(self, train: bool):
        return self._local.data(train)


#: the reference's name for the concept (DistributedDataSet)
DistributedDataSet = ShardedDataSet


def is_distributed_dataset(ds) -> bool:
    """Whether ``ds``, or the root of its transformer chain, is a rank's
    shard: the one predicate the ``Optimizer`` factory routes on and the
    ``DistriOptimizer`` reads its global batch from
    (bigdl_tpu/optim/optimizer.py:16-29).  A streaming root says so with
    its ``distributed`` attribute (``ShardFolder(..., distributed=True)``,
    ``SeqFileDataSet(distributed=True)``)."""
    while isinstance(ds, TransformedDataSet):
        ds = ds.base
    return isinstance(ds, ShardedDataSet) or bool(
        getattr(ds, "distributed", False))


class DataSet:
    """Factory namespace (ref object DataSet, DataSet.scala:271)."""

    @staticmethod
    def array(data, seed: int = 1, distributed: bool = False):
        """(ref DataSet.array :271-294); ``seed`` seeds the shuffles (the
        JAX package's process-wide default seed is 1); ``distributed``
        gives this rank's ``ShardedDataSet``."""
        if distributed:
            return ShardedDataSet(data, seed=seed)
        return LocalArrayDataSet(data, seed)

    @staticmethod
    def image_folder(path, distributed: bool = False, seed: int = 1):
        """Class-per-subfolder image dataset (ref DataSet.ImageFolder
        :322-379): ``(path, label)`` records, the labels 1-based floats in
        the sorted order of the class folders; decode happens in the
        transformer chain."""
        import os

        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        records = []
        for li, cls in enumerate(classes):
            d = os.path.join(path, cls)
            for f in sorted(os.listdir(d)):
                records.append((os.path.join(d, f), float(li + 1)))
        return DataSet.array(records, seed, distributed)

    @staticmethod
    def seq_file_folder(path, distributed: bool = False, class_num=None,
                        seed: int = 1):
        """Streaming packed-record dataset (ref DataSet.SeqFileFolder
        DataSet.scala:384-455): a folder of ``*.seq`` files is read as
        Hadoop SequenceFiles (``dataset.seqfile``), any other as a folder
        of the port's packed shards (``dataset.shardfile``, written by
        ``write_shards`` or ``imagenet_tools``).  A folder holding both
        raises, and so does ``class_num`` on a shard folder."""
        from bigdl_tpu_torch.dataset import seqfile

        # one listing decides the wire format
        names = seqfile.folder_listing(path)
        seq_files = seqfile.find_seq_files(path, names=names)
        if seq_files:
            bdts = [n for n in names if n.endswith(".bdts")]
            if bdts:
                raise ValueError(
                    f"{path} holds BOTH Hadoop SequenceFiles "
                    f"({len(seq_files)} *.seq) and packed shards "
                    f"({len(bdts)} *.bdts) — format selection would be "
                    "silent and order-dependent; split the folder (or "
                    "remove the stray files) so it holds exactly one "
                    "wire format")
            return seqfile.SeqFileDataSet(path, class_num=class_num,
                                          distributed=distributed,
                                          files=seq_files, seed=seed)
        if class_num is not None:
            raise ValueError(
                f"class_num is only supported for Hadoop SequenceFile "
                f"folders; {path} holds no .seq files")
        from bigdl_tpu_torch.dataset.shardfile import ShardFolder
        return ShardFolder(path, distributed=distributed, seed=seed)
