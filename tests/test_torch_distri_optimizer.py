"""The port's ``DistriOptimizer`` on the CPU under gloo, held against the
JAX ``DistriOptimizer`` on a mesh of the same size (conftest's virtual
CPU devices) and against the port's own ``LocalOptimizer``: the
counterparts of ``TestDistriOptimizer`` and its neighbours
(tests/test_distributed.py:123-327, 372-458), at their tolerances.

The ranks are spawned processes that import the port alone
(``tests/helpers/torch_distri_workers.py``); one spawn a world size runs
every case of that size in turn (``runs``), and the tests read its
results.  Weights cross from the JAX model built under ``set_seed(7)``;
the epoch order comes from the dataset's stream at the same seed on both
sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.dataset.dataset import AbstractDataSet as JaxAbstractDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JaxMiniBatch
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.optim import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, ImgNormalizer, ImgToBatch,
                                     SampleToBatch, ShardedDataSet, mnist)
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (DistriOptimizer, LocalOptimizer,
                                   global_batch_rule, load_latest_checkpoint,
                                   max_iteration, several_iteration)
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.utils.table import T
from tests.helpers import torch_distri_workers as W

TOL = dict(rtol=1e-4, atol=1e-5)          # tests/test_distributed.py:158
BF16_TOL = dict(rtol=2e-2, atol=2e-3)     # tests/test_distributed.py:186
Z1C_TOL = dict(rtol=1e-6, atol=1e-7)      # tests/test_distributed.py:222
MOM = {"learningRate": 0.1, "momentum": 0.9}
WD = {"learningRate": 0.1, "momentum": 0.9, "weightDecay": 1e-4}
CLASS_WEIGHTS = [0.5, 1.0, 2.0, 4.0]


def _data(n=64, d=8, classes=4):
    """tests/test_distributed.py:124-130."""
    rng = np.random.RandomState(0)
    w = rng.randn(d, classes)
    xs = rng.randn(n, d).astype(np.float32)
    ys = (xs @ w).argmax(1) + 1.0
    return xs, ys


def _tanh_data():
    """tests/test_distributed.py:416-421."""
    rs = np.random.RandomState(2)
    xs = rs.randn(48, 6).astype(np.float32)
    ys = (rs.randint(0, 3, 48) + 1).astype(np.float32)
    return xs, ys


def _jax_model(name):
    set_seed(7)
    if name == "mlp":
        return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                              jnn.Linear(16, 4), jnn.LogSoftMax())
    if name == "mlp17":
        return jnn.Sequential(jnn.Linear(8, 17), jnn.ReLU(),
                              jnn.Linear(17, 4), jnn.LogSoftMax())
    if name == "bn":
        return jnn.Sequential(jnn.Linear(8, 16), jnn.BatchNormalization(16),
                              jnn.ReLU(), jnn.Linear(16, 4),
                              jnn.LogSoftMax())
    if name == "tanh":
        return jnn.Sequential(jnn.Linear(6, 8), jnn.Tanh(), jnn.Linear(8, 3),
                              jnn.LogSoftMax())
    if name == "lenet":
        return JaxLeNet5(10)
    raise ValueError(name)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(name):
    return _numpy(_jax_model(name).params())


def _spec(name="mlp", data=None, **kw):
    xs, ys = _data() if data is None else data
    spec = dict(model=name, init=_init(name), xs=xs, ys=ys, batch=32,
                seed=5, iters=4, state={"learningRate": 0.1})
    spec.update(kw)
    return spec


def _jax_run(name, n, data=None, batch=32, seed=5, iters=4, state=None,
             criterion=None, n_disp=None, dataset=None, **kw):
    """The JAX DistriOptimizer on the first ``n`` virtual devices: (params,
    state, last loss) as numpy."""
    model = _jax_model(name)
    if dataset is None:
        xs, ys = _data() if data is None else data
        dataset = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                                    for x, y in zip(xs, ys)]) \
            >> JaxSampleToBatch(batch)
    opt = JaxDistriOptimizer(
        model, dataset, criterion or jnn.ClassNLLCriterion(),
        mesh=data_parallel_mesh(jax.devices()[:n]), **kw)
    opt.set_state(JaxT(**(state or {"learningRate": 0.1})))
    opt.set_end_when(jax_max_iteration(iters))
    if n_disp:
        opt.set_iterations_per_dispatch(n_disp)
    set_seed(seed)   # the epoch order: the JAX shuffle draws from here
    opt.optimize()
    return (_numpy(model.params()), _numpy(model.state()),
            float(opt.state["loss"]))


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_same(got, want):
    assert_trees(got, want, rtol=0, atol=0)


# -- the spawns: every case of one world size in one process group -------

def _world_specs():
    mlp17 = dict(WD)
    return {
        "local": _spec(optimizer="local"),
        "plain": _spec(),
        "local_m": _spec(optimizer="local", state=MOM),
        "plain_m": _spec(state=MOM),
        "zero1": _spec(state=MOM, kw={"zero1": True}),
        "bf16": _spec(kw={"gradient_compression": "bf16"}),
        "bf16_17": _spec("mlp17", state=mlp17,
                         kw={"gradient_compression": "bf16"}),
        "bf16z1_17": _spec("mlp17", state=mlp17,
                           kw={"gradient_compression": "bf16",
                               "zero1": True}),
        "bn_plain": _spec("bn"),
        "bn_bf16": _spec("bn", kw={"gradient_compression": "bf16"}),
        "weighted": _spec(criterion="nll_weighted",
                          class_weights=CLASS_WEIGHTS),
        "local_weighted": _spec(optimizer="local", criterion="nll_weighted",
                                class_weights=CLASS_WEIGHTS),
        "sum": _spec(criterion="nll_sum", state={"learningRate": 0.01}),
        "local_sum": _spec(optimizer="local", criterion="nll_sum",
                           state={"learningRate": 0.01}),
    }


def _world2_specs(tmp):
    specs = _world_specs()
    xs, ys = _data()
    specs.update({
        # the sharded dataset through the factory (test_trains_on_sharded_
        # dataset), validated every epoch, its first 16 records predicted
        "sharded": _spec(optimizer="factory", distributed=True, iters=20,
                         state={"learningRate": 0.5, "momentum": 0.9},
                         predict=xs[:16], validate=(xs, ys, 16)),
        "sharded_traj": _spec(data=_data(256), distributed=True, batch=16,
                              state=MOM),
        "n1": _spec("tanh", data=_tanh_data(), batch=16, seed=7, iters=6,
                    state={"learningRate": 0.2, "momentum": 0.9}),
        "n3": _spec("tanh", data=_tanh_data(), batch=16, seed=7, iters=6,
                    state={"learningRate": 0.2, "momentum": 0.9}, n_disp=3),
        "nan_ref": _spec(state=MOM, iters=1),
        "nan_plain": _spec(state=MOM, iters=2, poison={1: 2}),
        "nan_zero1": _spec(state=MOM, iters=2, poison={1: 2},
                           kw={"zero1": True}),
        "nan_bf16_ref": _spec(state=MOM, iters=1,
                              kw={"gradient_compression": "bf16"}),
        "nan_bf16": _spec(state=MOM, iters=2, poison={1: 2},
                          kw={"gradient_compression": "bf16"}),
        # zero1 with momentum writes a snapshot at neval 3 (an epoch
        # boundary: two steps an epoch), resumes from it, and resumes
        # from one the parent's LocalOptimizer wrote
        "ckpt_full": _spec(state=MOM, kw={"zero1": True},
                           checkpoint=(str(tmp / "distri"), 3)),
        "ckpt_resume": _spec(kw={"zero1": True}, resume=str(tmp / "distri")),
        "from_local": _spec(kw={"zero1": True}, resume=str(tmp / "local")),
        "lenet": _spec("lenet", mnist=(64, 0), batch=8, iters=3,
                       distributed=True, optimizer="factory",
                       state={"learningRate": 0.05, "momentum": 0.9}),
    })
    return specs


def _run_world(n, specs):
    names = list(specs)
    per_rank = launch(W.runs, n, "gloo", args=([specs[k] for k in names],))
    return [dict(zip(names, rank)) for rank in per_rank]


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distri")
    # the LocalOptimizer snapshot the world-2 DistriOptimizer resumes from
    model = W.build("mlp")
    load_jax_params(model, _init("mlp"))
    xs, ys = _data()
    opt = LocalOptimizer(model, DataSet.array(W.samples_of(xs, ys), seed=5)
                         >> SampleToBatch(32), nn.ClassNLLCriterion(),
                         device="cpu")
    opt.set_state(T(**MOM)).set_end_when(max_iteration(4))
    opt.set_checkpoint(str(tmp / "local"), several_iteration(3))
    opt.optimize()
    return tmp, export_params(model)


@pytest.fixture(scope="module")
def world1():
    specs = {"local": _spec(optimizer="local", state=WD),
             "plain": _spec(state=WD),
             "zero1": _spec(state=WD, kw={"zero1": True}),
             "local_bn": _spec("bn", optimizer="local", state=MOM),
             "bn": _spec("bn", state=MOM),
             "bn_zero1": _spec("bn", state=MOM, kw={"zero1": True}),
             "local_w": _spec(optimizer="local", criterion="nll_weighted",
                              class_weights=CLASS_WEIGHTS),
             "weighted": _spec(criterion="nll_weighted",
                               class_weights=CLASS_WEIGHTS),
             "bf16": _spec(state=WD, kw={"gradient_compression": "bf16"})}
    return _run_world(1, specs)[0]


@pytest.fixture(scope="module")
def world2(world_dir):
    return _run_world(2, _world2_specs(world_dir[0]))


@pytest.fixture(scope="module")
def world4():
    return _run_world(4, _world_specs())


@pytest.fixture(params=[2, 4])
def world(request, world2, world4):
    return request.param, {2: world2, 4: world4}[request.param]


# -- with one rank: LocalOptimizer's trajectory, bit for bit --------------

@pytest.mark.parametrize("name,local", [("plain", "local"),
                                        ("zero1", "local"),
                                        ("bn", "local_bn"),
                                        ("bn_zero1", "local_bn"),
                                        ("weighted", "local_w")])
def test_one_rank_is_local_optimizer_bit_for_bit(world1, name, local):
    got, want = world1[name], world1[local]
    assert got["type"] == "DistriOptimizer" and got["world"] == 1
    assert got["loss"] == want["loss"]
    assert_same(got["params"], want["params"])
    assert_same(got["state"], want["state"])
    assert_same(got["opt_state"], want["opt_state"])


def test_one_rank_bf16_rounds_the_gradient_only(world1):
    assert_trees(world1["bf16"]["params"], world1["local"]["params"],
                 **BF16_TOL)


# -- plain DP, zero1, bf16 and BN against the JAX DistriOptimizer ---------

def test_plain_matches_local_and_jax(world):
    """test_matches_local_optimizer: the same params as LocalOptimizer on
    one device for the same batches, and as the JAX DistriOptimizer."""
    n, runs = world
    for rank in runs:
        assert rank["plain"]["type"] == "DistriOptimizer"
        assert rank["plain"]["world"] == n
        assert_trees(rank["plain"]["params"], rank["local"]["params"], **TOL)
        assert_same(rank["plain"]["params"], runs[0]["plain"]["params"])
    params, _, loss = _jax_run("mlp", n)
    assert_trees(runs[0]["plain"]["params"], params, **TOL)
    np.testing.assert_allclose(runs[0]["plain"]["loss"][-1], loss, **TOL)


def test_zero1_matches_replicated_and_jax(world):
    """test_zero1_matches_replicated: the owner-partition update (a
    velocity of L/N a rank) gives the replicated trajectory."""
    n, runs = world
    params, _, _ = _jax_run("mlp", n, state=MOM, zero1=True)
    for rank in runs:
        z1 = rank["zero1"]
        assert z1["velocity_numel"] == z1["flat_length"] // n
        assert z1["wire_bytes"] == 4 * z1["flat_length"]
        assert_trees(z1["params"], rank["plain_m"]["params"], **TOL)
        assert_trees(z1["params"], rank["local_m"]["params"], **TOL)
        assert_trees(z1["opt_state"], rank["local_m"]["opt_state"], **TOL)
        assert_trees(z1["params"], params, **TOL)


def test_bf16_compression_matches_jax(world):
    """test_bf16_gradient_compression_matches_uncompressed, held to the
    JAX bf16 run at its tolerance (the bf16 sums run in another order)."""
    n, runs = world
    params, _, loss = _jax_run("mlp", n, gradient_compression="bf16")
    assert_trees(runs[0]["bf16"]["params"], params, **BF16_TOL)
    assert_trees(runs[0]["bf16"]["params"], runs[0]["plain"]["params"],
                 **BF16_TOL)
    np.testing.assert_allclose(runs[0]["bf16"]["loss"][-1], loss, **BF16_TOL)


def test_bf16_composes_with_zero1_on_a_padded_vector(world):
    """test_bf16_compression_composes_with_zero1: the 225-long flat vector
    (divides by neither 4 nor 8) padded to the world; compressed zero1
    equals compressed replicated, as on the power-of-two JAX axis."""
    n, runs = world
    for rank in runs:
        z1, rep = rank["bf16z1_17"], rank["bf16_17"]
        assert z1["flat_length"] == -(-225 // n) * n > 225
        assert z1["velocity_numel"] == z1["flat_length"] // n
        assert z1["wire_bytes"] == 2 * z1["flat_length"]
        assert_trees(z1["params"], rep["params"], **Z1C_TOL)
    params, _, _ = _jax_run("mlp17", n, state=WD, gradient_compression="bf16",
                            zero1=True)
    assert_trees(runs[0]["bf16z1_17"]["params"], params, **BF16_TOL)


def test_batchnorm_on_both_paths_matches_jax(world):
    """The plain path normalises by the global batch's statistics, as the
    JAX step under jit; the compressed one by each shard's, averaging
    the running statistics (test_gradient_compression_with_batchnorm)."""
    n, runs = world
    params, state, _ = _jax_run("bn", n)
    assert_trees(runs[0]["bn_plain"]["params"], params, **TOL)
    assert_trees(runs[0]["bn_plain"]["state"], state, **TOL)
    params_c, state_c, _ = _jax_run("bn", n, gradient_compression="bf16")
    assert_trees(runs[0]["bn_bf16"]["params"], params_c, **BF16_TOL)
    assert_trees(runs[0]["bn_bf16"]["state"], state_c, **BF16_TOL)
    for rank in runs:   # the merged running statistics agree
        assert_same(rank["bn_bf16"]["state"], runs[0]["bn_bf16"]["state"])
    # per-shard statistics differ from global ones by the between-shard
    # term: close, not equal (the JAX test's bound)
    assert_trees(runs[0]["bn_bf16"]["state"], runs[0]["bn_plain"]["state"],
                 rtol=0.35, atol=0.1)


def test_weighted_and_summed_criteria_take_the_global_batch(world):
    """A weighted ClassNLLCriterion normalises by the weights of every
    rank's targets, a summing one adds the ranks' sums: both equal
    LocalOptimizer on the whole batch, and the weighted one the JAX
    DistriOptimizer."""
    n, runs = world
    for rank in runs:
        assert_trees(rank["weighted"]["params"],
                     rank["local_weighted"]["params"], **TOL)
        assert_trees(rank["sum"]["params"], rank["local_sum"]["params"],
                     **TOL)
        np.testing.assert_allclose(rank["weighted"]["loss"],
                                   rank["local_weighted"]["loss"], **TOL)
    params, _, _ = _jax_run("mlp", n, criterion=jnn.ClassNLLCriterion(
        weights=np.asarray(CLASS_WEIGHTS, np.float32)))
    assert_trees(runs[0]["weighted"]["params"], params, **TOL)


def test_global_batch_rules():
    assert global_batch_rule(nn.ClassNLLCriterion()) == "mean"
    assert global_batch_rule(nn.ClassNLLCriterion(size_average=False)) \
        == "sum"
    assert global_batch_rule(nn.CrossEntropyCriterion(
        weights=CLASS_WEIGHTS)) == "weighted"
    assert global_batch_rule(nn.MSECriterion()) == "mean"
    assert global_batch_rule(nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(size_average=False))) == "sum"
    # the positions kept over the whole batch (an all-reduced count)
    assert global_batch_rule(nn.SoftmaxWithCriterion(ignore_label=255)) \
        == "kept"
    assert global_batch_rule(nn.SoftmaxWithCriterion(
        ignore_label=255, normalize_mode="batch_size")) == "mean"
    with pytest.raises(NotImplementedError):
        global_batch_rule(nn.MultiCriterion().add(nn.MSECriterion()).add(
            nn.AbsCriterion(size_average=False)))


def test_the_factory_routes_on_the_dataset():
    """The reference's Python-API keywords: ``training_rdd=`` shards the
    samples, so the factory gives a DistriOptimizer (here a world of
    one, formed without a launcher); a replicated dataset gives a
    LocalOptimizer, which takes no data-parallel argument."""
    from bigdl_tpu_torch.optim import Optimizer, is_distributed_dataset
    from bigdl_tpu_torch.utils.engine import Engine

    xs, ys = _data()
    try:
        opt = Optimizer(W.build("mlp"), training_rdd=W.samples_of(xs, ys),
                        criterion=nn.ClassNLLCriterion(), batch_size=32,
                        device="cpu", zero1=True)
        assert isinstance(opt, DistriOptimizer) and opt.zero1
        assert opt.mesh.shape == {"data": 1}
        assert is_distributed_dataset(opt.dataset)
    finally:
        Engine.reset()
    ds = DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(32)
    assert not is_distributed_dataset(ds)
    opt = Optimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(), device="cpu")
    assert type(opt) is LocalOptimizer
    with pytest.raises(TypeError):
        Optimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(), device="cpu",
                  zero1=True)


def test_gradient_compression_rejects_bad_mode():
    xs, ys = _data()
    ds = DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(32)
    with pytest.raises(ValueError):
        DistriOptimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(),
                        gradient_compression="int8", device="cpu")
    # the JAX words: no single flat wire under tensor parallelism
    with pytest.raises(ValueError, match="gradient_compression composes "
                                         "with DP and zero1, not "
                                         "tensor_parallel"):
        DistriOptimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(),
                        tensor_parallel=True, gradient_compression="bf16",
                        device="cpu")


def test_elastic_recovery_is_refused(monkeypatch):
    """The JAX package's recover-in-place (``BIGDL_ELASTIC=1``) is not
    ported: the optimizer refuses the setting rather than fail fast
    where the user asked for recovery."""
    xs, ys = _data()
    ds = DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(32)
    monkeypatch.setenv("BIGDL_ELASTIC", "1")
    with pytest.raises(NotImplementedError, match="resilience slice"):
        DistriOptimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(),
                        device="cpu")


# -- the sharded dataset --------------------------------------------------

def test_trains_on_sharded_dataset(world2):
    """test_trains_on_sharded_dataset: the factory returns a
    DistriOptimizer for a sharded dataset, and it learns something real;
    every rank validates the same result, LocalOptimizer's over the
    whole set."""
    xs, ys = _data()
    for rank in world2:
        got = rank["sharded"]
        assert got["type"] == "DistriOptimizer"
        acc = float((got["predict"].argmax(1) + 1 == ys[:16]).mean())
        assert acc > 0.5
        assert got["validation"] == world2[0]["sharded"]["validation"]
        # 20 steps of a global 64 over 64 records: one epoch a step
        assert got["epoch"] == 21 and got["neval"] == 21
    model = W.build("mlp")
    load_jax_params(model, world2[0]["sharded"]["params"])
    opt = LocalOptimizer(model, DataSet.array(W.samples_of(xs, ys))
                         >> SampleToBatch(16), nn.ClassNLLCriterion(),
                         device="cpu")
    from bigdl_tpu_torch.optim import Top1Accuracy, validate
    (_, want), = validate(model, opt.dataset, [Top1Accuracy()], "cpu")
    assert world2[0]["sharded"]["validation"][-1]["Top1Accuracy"] == \
        want.result()[0]


class _Batches(AbstractDataSet):
    """Fixed global batches in order (the port's MiniBatch)."""

    def __init__(self, batches, size):
        self._batches, self._size = batches, size

    def size(self):
        return self._size

    def shuffle(self):
        return self

    def data(self, train):
        return iter(self._batches)


class _JaxBatches(JaxAbstractDataSet):
    def __init__(self, batches, size):
        self._batches, self._size = batches, size

    def size(self):
        return self._size

    def shuffle(self):
        return self

    def data(self, train):
        return iter(self._batches)


def _interleaved(make, n_ranks, steps):
    """Each step's global batch: the ranks' local batches stacked in rank
    order, each drawn as that rank's ShardedDataSet draws it."""
    its = [iter(make(r).data(train=True)) for r in range(n_ranks)]
    out = []
    for _ in range(steps):
        parts = [next(it) for it in its]
        out.append((np.concatenate([np.asarray(p.data) for p in parts]),
                    np.concatenate([np.asarray(p.labels) for p in parts])))
    return out


def test_sharded_trajectory_is_local_on_interleaved_batches(world2):
    """World 2 on a sharded dataset: each step's global batch is the two
    ranks' local batches; LocalOptimizer on those batches, and the JAX
    DistriOptimizer on a 2-device mesh, take the same trajectory."""
    xs, ys = _data(256)
    batches = _interleaved(lambda r: ShardedDataSet(
        W.samples_of(xs, ys), 2, r, seed=5) >> SampleToBatch(16), 2, 4)
    model = W.build("mlp")
    load_jax_params(model, _init("mlp"))
    opt = LocalOptimizer(model, _Batches([MiniBatch(x, y) for x, y in
                                          batches], 256),
                         nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(**MOM)).set_end_when(max_iteration(4)).optimize()
    got = world2[0]["sharded_traj"]
    assert got["epoch"] == 1 and got["neval"] == 5
    assert_trees(got["params"], export_params(model), **TOL)
    np.testing.assert_allclose(got["loss"], [l for _, l in opt.loss_log],
                               **TOL)
    params, _, _ = _jax_run("mlp", 2, state=MOM, dataset=_JaxBatches(
        [JaxMiniBatch(x, y) for x, y in batches], 256))
    assert_trees(got["params"], params, **TOL)


def test_lenet_through_the_factory_matches_jax(world2, monkeypatch):
    """examples/train_lenet.py --distributed at a small size:
    ``Optimizer(model, DataSet.array(..., distributed=True) >> ...)`` is
    a DistriOptimizer, and its world-2 run is the JAX DistriOptimizer's
    on the interleaved global batches."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    got = world2[0]["lenet"]
    assert got["type"] == "DistriOptimizer"
    norm = ImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    batches = _interleaved(lambda r: ShardedDataSet(
        mnist.synthetic(64, 0), 2, r, seed=5) >> norm >> ImgToBatch(8), 2, 3)
    params, _, loss = _jax_run(
        "lenet", 2, state={"learningRate": 0.05, "momentum": 0.9}, iters=3,
        dataset=_JaxBatches([JaxMiniBatch(jnp.asarray(x), y)
                             for x, y in batches], 64))
    assert_trees(got["params"], params, **TOL)
    np.testing.assert_allclose(got["loss"][-1], loss, **TOL)


# -- chunks, the finite guard, checkpoints --------------------------------

def test_three_a_dispatch_equals_one(world2):
    """test_distri_iterations_per_dispatch_matches_single_step: 48
    records in batches of 16, chunks of 3 on the epoch boundary."""
    for rank in world2:
        one, three = rank["n1"], rank["n3"]
        assert one["neval"] == three["neval"] == 7
        np.testing.assert_allclose(one["loss"][-1], three["loss"][-1],
                                   rtol=1e-5)
        assert_trees(three["params"], one["params"], rtol=1e-5, atol=1e-6)
    params, _, _ = _jax_run("tanh", 2, data=_tanh_data(), batch=16, seed=7,
                            iters=6, state={"learningRate": 0.2,
                                            "momentum": 0.9})
    assert_trees(world2[0]["n1"]["params"], params, **TOL)


@pytest.mark.parametrize("name,ref", [("nan_plain", "nan_ref"),
                                      ("nan_zero1", "nan_ref"),
                                      ("nan_bf16", "nan_bf16_ref")])
def test_one_ranks_nan_skips_the_step_on_every_rank(world2, name, ref):
    """Rank 1's input is NaN at step 2: every rank skips that update
    (params and velocity as after step 1) and counts it."""
    for rank in world2:
        got = rank[name]
        assert got["skips"] == 1 and got["neval"] == 3
        assert np.isnan(got["loss"][-1])
        assert_same(got["params"], rank[ref]["params"])
        assert_same(got["opt_state"], rank[ref]["opt_state"])
        assert_same(got["params"], world2[0][name]["params"])


def test_checkpoints_cross_between_the_optimizers(world2, world_dir):
    """Rank 0 writes LocalOptimizer's files (zero1's velocity gathered);
    a DistriOptimizer resumes from its own snapshot and from a
    LocalOptimizer's, a LocalOptimizer from the DistriOptimizer's: each
    ends where the uninterrupted run ends."""
    tmp, local_final = world_dir
    full = world2[0]["ckpt_full"]
    for rank in world2:
        assert_trees(rank["ckpt_resume"]["params"], full["params"], **TOL)
        assert rank["ckpt_resume"]["neval"] == full["neval"] == 5
        assert_trees(rank["from_local"]["params"], local_final, **TOL)
    got = load_latest_checkpoint(str(tmp / "distri"), device="cpu")
    assert got is not None and got[2] == 3
    module, blob, _ = got
    velocity = blob["opt_state"]["velocity"]
    assert jax.tree_util.tree_structure(velocity) == \
        jax.tree_util.tree_structure(full["params"])
    # LocalOptimizer resumes the DistriOptimizer's snapshot
    xs, ys = _data()
    ds = DataSet.array(W.samples_of(xs, ys), seed=5) >> SampleToBatch(32)
    module, blob, _ = load_latest_checkpoint(str(tmp / "distri"),
                                             restore_rng=True, device="cpu",
                                             dataset=ds)
    opt = LocalOptimizer(module, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(blob["state"]).set_optim_state(blob["opt_state"])
    opt.set_end_when(max_iteration(4)).optimize()
    assert_trees(export_params(module), full["params"], **TOL)


def test_metrics_gather_one_mean_a_rank(world2):
    for rank in world2:
        per = rank["plain"]["per_node"]
        assert len(per) == 2 and all(v > 0 for v in per)
        assert per == world2[0]["plain"]["per_node"]


def test_sync_batchnorm_matches_the_global_batch():
    """The cross-rank batch norm at world 2, each rank holding half the
    batch, against the JAX BatchNormalization on the whole batch: y, dx,
    the running statistics, and dγ, dβ summed over the ranks (as the
    gradient all-reduce sums them)."""
    from bigdl_tpu.nn.module import Context
    rs = np.random.RandomState(3)
    x = (rs.randn(8, 5, 3, 3) * 2 + 1).astype(np.float32)
    g = rs.randn(8, 5, 3, 3).astype(np.float32)
    set_seed(1)
    jm = jnn.SpatialBatchNormalization(5)
    params = jm.params()
    out = launch(W.sync_bn_case, 2, "gloo", args=(_numpy(params), x, g))

    def f(p, v):
        return jm.apply(p, v, jm.state(), Context(training=True))

    (y, state), vjp = jax.vjp(f, params, jnp.asarray(x))
    dp, dx = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like,
                                                          state)))
    for r, rank in enumerate(out):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(rank["y"], np.asarray(y)[rows], **TOL)
        np.testing.assert_allclose(rank["dx"], np.asarray(dx)[rows], **TOL)
        assert_trees(rank["state"], _numpy(state), **TOL)
    np.testing.assert_allclose(out[0]["dw"] + out[1]["dw"],
                               np.asarray(dp["~"]["weight"]), **TOL)
    np.testing.assert_allclose(out[0]["db"] + out[1]["db"],
                               np.asarray(dp["~"]["bias"]), **TOL)
