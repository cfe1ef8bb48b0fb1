"""Tensor parallelism of the port under gloo
(``DistriOptimizer(tensor_parallel=True)`` on ``hybrid_mesh``, the
layers' ``model_axis`` forms, ``parallel/sharding.py``'s rules), held
against the JAX package on the conftest CPU mesh: the rules' decisions
leaf by leaf; dp x tp against plain DP and the JAX
``DistriOptimizer(tensor_parallel=True)``, with and without ``zero1``
(tests/test_distributed.py:341-405, their tolerance); the attention
classifier at ``{"data": 1, "model": 2}`` against the JAX run; a module
with no tensor-parallel form (an LSTM ``Recurrent``) through the
gathered route against DP; a checkpoint mid-run resumed; a world of one
against ``LocalOptimizer`` bit for bit.

The ranks are spawned processes that import the port alone
(``tests/helpers/torch_distri_workers.py``); each world size is spawned
once and runs every case of its size."""
import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.models.transformer import TransformerClassifier as JTC
from bigdl_tpu.models.vgg import VggForCifar10 as JVgg
from bigdl_tpu.optim import DistriOptimizer as JDistriOptimizer
from bigdl_tpu.optim import max_iteration as jmax_iteration
from bigdl_tpu.parallel.mesh import hybrid_mesh as jhybrid_mesh
from bigdl_tpu.parallel.sharding import shard_params_rule as jshard_rule
from bigdl_tpu.parallel.sharding import zero1_tp_rule as jzero1_tp_rule
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch.parallel.launch import launch
from bigdl_tpu_torch.parallel.sharding import (model_slice,
                                               shard_params_rule,
                                               zero1_tp_rule)
from tests.helpers import torch_distri_workers as W

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_distributed.py:366, :403
MOM = {"learningRate": 0.1, "momentum": 0.9}
CLS = dict(class_num=4, d_model=16, n_heads=2, n_layers=2, hidden=32,
           dropout=0.0)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(name):
    set_seed(11)
    if name == "mlp":   # tests/test_distributed.py:356-357
        return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                              jnn.Linear(16, 4), jnn.LogSoftMax())
    if name == "classifier":
        return JTC(**CLS)
    if name == "lenet":
        return JLeNet5(10)
    if name == "vgg":
        return JVgg(10)
    raise ValueError(name)


def _mlp_data():
    """tests/test_distributed.py:348-351."""
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for _ in range(64):
        xs.append(rng.randn(8).astype(np.float32))
        ys.append(float(rng.randint(1, 5)))
    return np.stack(xs), np.asarray(ys)


def _cls_data():
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 8, 16).astype(np.float32)
    return xs, np.asarray([float(i % 4 + 1) for i in range(32)])


def _spec(name="mlp", mesh=None, kw=None, **extra):
    xs, ys = _cls_data() if name == "classifier" else _mlp_data()
    init = extra.pop("init", None)
    spec = dict(model=name, arch=CLS if name == "classifier" else None,
                init=(_numpy(_jax_model(name).params()) if init is None
                      else init), xs=xs, ys=ys,
                batch=16 if name == "classifier" else 32, seed=5, iters=4,
                state=MOM, mesh=mesh, kw=kw or {})
    spec.update(extra)
    return spec


def _tp(name="mlp", mesh=None, **kw):
    return _spec(name, mesh or {"data": 2, "model": 2},
                 {"tensor_parallel": True, **kw.pop("opt", {})}, **kw)


def _jax_run(name, dp, mp, **kw):
    """The JAX DistriOptimizer(tensor_parallel=True) at hybrid_mesh(dp,
    mp) on the first dp·mp devices: (params, last loss)."""
    model = _jax_model(name)
    xs, ys = _cls_data() if name == "classifier" else _mlp_data()
    ds = JDataSet.array([JSample(x, np.asarray([y], np.float32))
                         for x, y in zip(xs, ys)]) \
        >> JSampleToBatch(16 if name == "classifier" else 32)
    opt = JDistriOptimizer(model, ds, jnn.ClassNLLCriterion(),
                           mesh=jhybrid_mesh(dp, mp, jax.devices()[:dp * mp]),
                           tensor_parallel=True, **kw)
    opt.set_state(JT(**MOM))
    opt.set_end_when(jmax_iteration(4))
    set_seed(5)   # the epoch order
    opt.optimize()
    return _numpy(model.params()), float(opt.state["loss"])


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# -- the rules ----------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "vgg", "mlp", "classifier"])
@pytest.mark.parametrize("mp", [1, 2, 4])
def test_rules_decide_as_jax(name, mp):
    """``shard_params_rule`` and ``zero1_tp_rule`` give every leaf the
    decision of the JAX rule's ``PartitionSpec`` at hybrid_mesh(8 // mp,
    mp)."""
    mesh = jhybrid_mesh(8 // mp, mp, jax.devices()[:8])
    jrule, jzrule = jshard_rule(mesh), jzero1_tp_rule(mesh)
    rule = shard_params_rule({"data": 8 // mp, "model": mp})
    zrule = zero1_tp_rule({"data": 8 // mp, "model": mp})
    leaves = jax.tree_util.tree_leaves(_jax_model(name).params())
    decided = set()
    for leaf in leaves:
        assert rule(leaf.shape) == tuple(jrule(leaf).spec)
        assert zrule(leaf.shape) == tuple(jzrule(leaf).spec)
        decided.add(zrule(leaf.shape))
    if mp == 1:
        assert all(rule(x.shape) == () for x in leaves)
    if mp == 2 and name in ("vgg", "classifier"):
        assert ("model", "data") in decided and ("data",) in decided


def test_model_slice_is_rows_in_rank_order():
    rows = np.arange(12)
    parts = [rows[model_slice(12, i, 4)] for i in range(4)]
    assert np.array_equal(np.concatenate(parts), rows)
    assert [len(p) for p in parts] == [3] * 4


# -- the worlds ---------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    xs, ys = _mlp_data()
    rs = np.random.RandomState(0)
    lx = rs.randn(32, 8, 16).astype(np.float32)
    ly = np.asarray([float(i % 4 + 1) for i in range(32)])
    lstm = W.export_params(W.build("lstm"))
    specs = {
        "dp": _spec(mesh={"data": 4}),
        "tp": _tp(),
        "tp_zero1": _tp(opt={"zero1": True}),
        "tp_validate": _tp(iters=2, validate=(xs[:40], ys[:40], 16, 2)),
        "dp_validate": _spec(mesh={"data": 4}, iters=2,
                             validate=(xs[:40], ys[:40], 16, 2)),
        "tp_ckpt": _tp(iters=2, checkpoint=(str(tmp / "a"), 3)),
        "tp_resume": _tp(iters=4, resume=str(tmp / "a")),
        "lstm_tp": _tp("lstm", init=lstm, xs=lx, ys=ly, batch=16),
        "lstm_dp": _spec("lstm", mesh={"data": 4}, init=lstm, xs=lx, ys=ly,
                         batch=16),
    }
    names = list(specs)
    return [dict(zip(names, r)) for r in launch(
        W.runs, 4, "gloo", args=([specs[k] for k in names],))]


@pytest.fixture(scope="module")
def world2():
    specs = {"classifier": _tp("classifier", {"data": 1, "model": 2})}
    names = list(specs)
    return [dict(zip(names, r)) for r in launch(
        W.runs, 2, "gloo", args=([specs[k] for k in names],))]


@pytest.fixture(scope="module")
def world1():
    specs = {
        "mlp": _tp(mesh={"data": 1, "model": 1}),
        "mlp_zero1": _tp(mesh={"data": 1, "model": 1},
                         opt={"zero1": True}),
        "mlp_local": _spec(optimizer="local"),
        "classifier": _tp("classifier", {"data": 1, "model": 1}),
        "classifier_local": _spec("classifier", optimizer="local"),
    }
    names = list(specs)
    return dict(zip(names, launch(W.runs, 1, "gloo",
                                  args=([specs[k] for k in names],))[0]))


@pytest.mark.parametrize("mode", ["tp", "tp_zero1"])
def test_dp_tp_matches_dp_and_jax(world4, mode):
    """test_dp_tp_hybrid_matches_dp and test_zero1_matches_replicated's
    TP case at hybrid_mesh(2, 2): four steps, every parameter against the
    port's plain DP and the JAX tensor-parallel run; the ranks' coordinates
    row-major; each rank's velocity holds its part of the flat layout."""
    jparams, jloss = _jax_run("mlp", 2, 2, zero1=mode == "tp_zero1")
    for r, rank in enumerate(world4):
        run = rank[mode]
        assert run["coords"] == {"data": r // 2, "model": r % 2}
        assert_trees(run["params"], rank["dp"]["params"], **TOL)
        assert_trees(run["params"], jparams, **TOL)
        np.testing.assert_allclose(run["loss"][-1], jloss, **TOL)
        np.testing.assert_allclose(run["loss"], rank["dp"]["loss"], **TOL)
        assert_trees(run["opt_state"], rank["dp"]["opt_state"], **TOL)
        assert run["tp_gathered"] == {}
        # both weights split over the model axis (16 and 4 rows), the
        # biases whole: 64 + 8 + 16 + 4 floats a rank, and under zero1
        # half of that padded flat layout over the data axis
        whole = 8 * 16 + 16 + 16 * 4 + 4
        part = 8 * 16 // 2 + 16 + 16 * 4 // 2 + 4
        assert run["velocity_numel"] == (part // 2 if mode == "tp_zero1"
                                         else part) < whole


def test_validation_counts_each_data_slice_once(world4):
    """Under tensor parallelism the model ranks of a data slice validate
    its batches together: Top1 and the loss equal plain DP's."""
    for rank in world4:
        got, want = rank["tp_validate"]["validation"], \
            rank["dp_validate"]["validation"]
        assert len(got) == len(want) == 1
        assert got[0]["Top1Accuracy"] == want[0]["Top1Accuracy"]
        np.testing.assert_allclose(got[0]["Loss"], want[0]["Loss"],
                                   rtol=1e-5)


def test_checkpoint_resume_matches_uninterrupted(world4):
    """A snapshot after two steps (an epoch boundary; the whole leaves in
    the file, gathered from the model ranks) resumed for two more lands
    on the four-step run."""
    for rank in world4:
        assert rank["tp_resume"]["neval"] == rank["tp"]["neval"] == 5
        assert_trees(rank["tp_resume"]["params"], rank["tp"]["params"],
                     rtol=1e-6, atol=1e-7)


def test_a_module_without_a_form_runs_gathered(world4):
    """An LSTM ``Recurrent`` holds a weight the rule shards (4H = 32
    rows) and has no tensor-parallel form: it computes with the weight
    all-gathered, its gradient back to the rows; the trajectory is
    DP's."""
    for rank in world4:
        run = rank["lstm_tp"]
        assert run["tp_gathered"] == {"LSTMCell": 1}
        assert_trees(run["params"], rank["lstm_dp"]["params"], **TOL)
        np.testing.assert_allclose(run["loss"], rank["lstm_dp"]["loss"],
                                   **TOL)


def test_classifier_matches_jax_tensor_parallel(world2):
    """The two-layer attention classifier at narrow width on ``{"data":
    1, "model": 2}``: the attention row-parallel, the FFN and the head
    column-parallel, four steps against the JAX tensor-parallel run."""
    jparams, jloss = _jax_run("classifier", 1, 2)
    for rank in world2:
        run = rank["classifier"]
        assert run["tp_gathered"] == {}
        assert_trees(run["params"], jparams, **TOL)
        np.testing.assert_allclose(run["loss"][-1], jloss, **TOL)


@pytest.mark.parametrize("name,local", [("mlp", "mlp_local"),
                                        ("mlp_zero1", "mlp_local"),
                                        ("classifier", "classifier_local")])
def test_one_rank_is_local_optimizer_bit_for_bit(world1, name, local):
    """At ``{"data": 1, "model": 1}`` the rule replicates every leaf: the
    run is LocalOptimizer's, bit for bit."""
    got, want = world1[name], world1[local]
    assert got["type"] == "DistriOptimizer" and got["world"] == 1
    assert got["loss"] == want["loss"]
    assert_trees(got["params"], want["params"], rtol=0, atol=0)


# -- refusals -------------------------------------------------------------

def test_invalid_combinations_are_the_jax_words():
    """The JAX constructor's words for what tensor parallelism does not
    combine with (bigdl_tpu/optim/distri_optimizer.py:169-197, :236-238),
    and a model axis the run was not told to use."""
    import re

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import DistriOptimizer
    from bigdl_tpu_torch.parallel import hybrid_mesh

    xs, ys = _mlp_data()

    def make(**kw):
        ds = DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(32)
        return DistriOptimizer(W.build("mlp"), ds, nn.ClassNLLCriterion(),
                               device="cpu", **kw)

    with pytest.raises(ValueError, match=re.escape(
            "gradient_compression composes with DP and zero1, not "
            "tensor_parallel: TP grads are per-leaf sharded over the model "
            "axis, so there is no single flat gradient wire to compress "
            "(the reference has no TP at all)")):
        make(tensor_parallel=True, gradient_compression="bf16")
    with pytest.raises(ValueError, match=re.escape(
            "sequence_parallel composes with data parallelism only (mesh "
            "{'data': d, 'seq': s})")):
        make(tensor_parallel=True, sequence_parallel=True)
    with pytest.raises(ValueError, match=re.escape(
            "expert_parallel composes with data parallelism only (mesh "
            "{'data': d, 'expert': e}); tensor_parallel/zero1/")):
        make(tensor_parallel=True, expert_parallel=True)
    with pytest.raises(ValueError, match="straggler drop masks "
                                         "per-DATA-replica gradients"):
        make(tensor_parallel=True, drop_percentage=0.1)
    mesh = hybrid_mesh(1, 1, "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=re.escape(
            "a mesh with axes ('data', 'model') needs")):
        make(mesh=mesh)
    opt = make(mesh=mesh, tensor_parallel=True)
    with pytest.raises(ValueError, match="straggler drop masks"):
        opt.set_drop_module_property(0.1, 0.1)
