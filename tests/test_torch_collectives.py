"""The port's process topology and collectives on the CPU under gloo: the
mesh of the ``data`` axis, the reduce-scatter / all-gather round trip
(tests/test_distributed.py:46-64), the all-gather in place, the
broadcast of rank 0's model, ``axis_index`` / ``axis_size``, the
per-rank metrics, the engine's world of one and its backend check, the
launcher's error path, the flat partition, and ``ShardedDataSet``
against the JAX one built with the same ``n_shards`` and
``shard_index``.  The ranks are spawned processes that import the port
alone (``tests/helpers/torch_distri_workers.py``)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.dataset import ShardedDataSet as JaxShardedDataSet
from bigdl_tpu.dataset.dataset import get_batch_size as jax_get_batch_size
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.dataset import DataSet, ShardedDataSet, get_batch_size
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.nn.module import export_params
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.parallel.mesh import make_mesh
from bigdl_tpu_torch.parallel.sharding import FlatPartition
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.random import generator
from tests.helpers import torch_distri_workers as W

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def worlds():
    return {n: launch(W.collectives_case, n, "gloo") for n in (2, 4)}


@pytest.fixture(params=[2, 4])
def world(request, worlds):
    return request.param, worlds[request.param]


def test_mesh_construction(world):
    n, ranks = world
    for r, out in enumerate(ranks):
        assert out["mesh"] == ({"data": n}, ("data",), r, n, r, n)
        # a size that is not the world's, a model axis the world cannot
        # hold, an axis set of no mesh and a reduce-scatter of a length
        # the world does not divide: refused; the hybrid mesh of the
        # world's data ranks and one model rank forms
        assert out["refused"] == ["ValueError", "ValueError", None,
                                  "ValueError", "ValueError"]


def test_mesh_axes_of_a_later_slice_raise_without_a_group():
    """The model and pipe axes form meshes now (the tensor- and
    pipeline-parallel files build them across ranks); an axis set that
    makes no mesh of the port is refused before any process group."""
    for axes in ({"model": 2}, {"pipe": 2, "model": 2},
                 {"data": 1, "pipe": 1, "seq": 1}, {"model": 2, "expert": 2}):
        with pytest.raises(ValueError, match="a mesh of the port has"):
            make_mesh(axes, "cpu")


def test_axis_index_and_size(world):
    n, ranks = world
    assert [o["axis_index"] for o in ranks] == list(range(n))
    assert all(o["axis_size"] == n for o in ranks)


def test_reduce_scatter_all_gather_roundtrip(world):
    """reduce-scatter + all-gather == all-reduce: the decomposition the
    reference implements by hand (SURVEY.md §2.5)."""
    n, ranks = world
    vs = [np.random.RandomState(r).randn(3 * n).astype(np.float32)
          for r in range(n)]
    total = np.sum(vs, axis=0)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["rs"], total[3 * r:3 * r + 3],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["rs_ag"], out["ar"], rtol=1e-5)
        np.testing.assert_allclose(out["ar"], total, rtol=1e-5)
        np.testing.assert_allclose(out["mean"], total / n, rtol=1e-5)
        np.testing.assert_array_equal(out["bf16_sum"],
                                      np.full(4, n * (n + 1) / 2))


def test_all_gather_in_place(world):
    n, ranks = world
    want = np.concatenate([[10.0 * r, 10.0 * r + 1] for r in range(n)])
    for out in ranks:
        np.testing.assert_array_equal(out["inplace"], want)


def test_broadcast_from_host0(world):
    """Every rank ends with rank 0's tensors (two dtypes) and rank 0's
    model, though each drew its own."""
    n, ranks = world
    for out in ranks:
        np.testing.assert_array_equal(out["broadcast"][0], np.zeros(3))
        np.testing.assert_array_equal(out["broadcast"][1], np.arange(4))
        np.testing.assert_array_equal(out["broadcast"][2], np.zeros((2, 2)))
    want = export_params(LeNet5(10, device="cpu", generator=generator(0)))
    for out in ranks:
        for a, b in zip(jax.tree_util.tree_leaves(out["model"]),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_metrics_gather_one_mean_a_rank(world):
    n, ranks = world
    want = [2.0 + r for r in range(n)]
    for out in ranks:
        assert out["per_node_live"] == want
        assert out["per_node"] == want
        assert "per node" in out["summary"]


def test_launch_raises_a_ranks_exception_with_its_rank():
    with pytest.raises(ValueError, match="raised by rank 1") as info:
        launch(W.fail_on, 2, "gloo", args=(1,))
    assert any("rank 1 of 2" in note for note in info.value.__notes__)
    assert launch(W.fail_on, 2, "gloo", args=(5,)) == [0, 1]


def test_engine_forms_a_world_of_one_without_a_launcher():
    """No group and no torchrun variables: a world of one (as
    ``jax.process_count() == 1``), gloo for the CPU; a backend that does
    not serve the device is refused before any group forms."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    probe = ("from bigdl_tpu_torch.utils.engine import Engine\n"
             "import torch.distributed as dist\n"
             "Engine.init_distributed(device='cpu')\n"
             "print(Engine.device_count(), Engine.process_index(), "
             "dist.get_backend(), Engine.node_number(), "
             "Engine.device('cpu'))\n"
             "Engine.reset(); print(dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0", "gloo", "1", "cpu", "False"]
    with pytest.raises(ValueError, match="does not serve"):
        Engine.init_distributed(device="cpu", backend="nccl")


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_flat_partition_pads_to_the_world(world):
    """The padded length is the JAX compressed-zero1 ``_z1c_flat``: the
    raveled parameter count rounded up to the world; each rank owns one
    contiguous slice; the views cover every parameter once."""
    set_seed(3)
    jm = jnn.Sequential(jnn.Linear(8, 17), jnn.ReLU(), jnn.Linear(17, 4),
                        jnn.LogSoftMax())
    total = int(ravel_pytree(jm.params())[0].size)
    shapes = [(17, 8), (17,), (4, 17), (4,)]
    part = FlatPartition(shapes, world)
    assert total == part.n_params == part.total == 225
    assert part.length == total + (-total) % world
    assert part.slice_len * world == part.length
    owned = [part.owned(r) for r in range(world)]
    assert owned[0].start == 0 and owned[-1].stop == part.length
    assert all(a.stop == b.start for a, b in zip(owned, owned[1:]))
    flat = np.arange(part.length, dtype=np.float32)
    views = part.views(flat)
    assert [v.shape for v in views] == shapes
    covered = np.concatenate([v.reshape(-1) for v in views])
    np.testing.assert_array_equal(covered, np.arange(225))


def test_flat_partition_aligns_leaves_on_the_card():
    part = FlatPartition([(17, 8), (17,), (4, 17), (4,)], 4, align=128)
    assert part.offsets == [0, 256, 384, 512]
    assert part.total == 516 and part.length == 516
    assert part.n_params == 225


def test_get_batch_size_matches_jax():
    assert get_batch_size(128, 4) == jax_get_batch_size(128, 4) == 32
    with pytest.raises(ValueError):
        get_batch_size(30, 4)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("seed", [1, 5])
def test_sharded_dataset_matches_jax(n_shards, seed):
    """The same records in the same order as the JAX ShardedDataSet
    under the same seed: two looped passes, a shuffle (the epoch
    rollover), another pass, and the evaluation pass."""
    records = list(range(23))
    for r in range(n_shards):
        set_seed(seed)
        jds = JaxShardedDataSet(records, n_shards=n_shards, shard_index=r)
        pds = ShardedDataSet(records, n_shards, r, seed=seed)
        assert pds.size() == jds.size() == 23
        assert pds.shard_size() == jds.shard_size()

        def draws(ds):
            it = ds.data(train=True)
            first = [next(it) for _ in range(2 * ds.shard_size() + 1)]
            ds.shuffle()
            it = ds.data(train=True)
            return first, [next(it) for _ in range(ds.shard_size())], \
                list(ds.data(train=False))

        jax_draws = draws(jds)
        port_draws = draws(pds)
        assert port_draws == jax_draws


def test_distributed_array_takes_the_ranks_shard():
    ds = DataSet.array(range(10), seed=2, distributed=True)
    assert isinstance(ds, ShardedDataSet)
    assert (ds.n_shards, ds.shard_index, ds.size(), ds.shard_size()) == \
        (1, 0, 10, 10)
    with pytest.raises(ValueError):
        ShardedDataSet(range(10), 2, 2)
