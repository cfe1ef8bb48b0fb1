"""``DistriOptimizer(expert_parallel=True)`` of the port under gloo, and
``nn.MoE`` under plain data parallelism, held against the JAX local run
(tests/test_moe_layer.py:96-127: the loss within 1e-5, parameters rtol
2e-5 / atol 2e-6): both gate the global batch, as the JAX step under
``jit`` does, so a capacity that drops tokens leaves the trajectory
where the local run's is.  Also: only the expert-stacked leaves are
owner-sharded, a world of one is ``LocalOptimizer`` bit for bit, the
JAX validations word for word, and the plain path's rule for
``SoftmaxWithCriterion`` with an ignore label (the positions kept over
the whole batch) against the JAX ``DistriOptimizer``.  The ranks import
the port alone (``tests/helpers/torch_distri_workers.py``)."""
import re

import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.transformer import TransformerClassifier as JTC
from bigdl_tpu.optim import DistriOptimizer as JDistriOptimizer
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import max_iteration as jmax_iteration
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
from bigdl_tpu_torch.optim import DistriOptimizer
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W

LOSS_TOL = 1e-5                     # tests/test_moe_layer.py:112
TOL = dict(rtol=2e-5, atol=2e-6)    # tests/test_moe_layer.py:116
MOM = {"learningRate": 0.1, "momentum": 0.9}
CLS = dict(class_num=4, d_model=16, n_heads=2, n_layers=1, hidden=32,
           dropout=0.0, moe_experts=4)


def _moe_data():
    """tests/test_moe_layer.py:_moe_ds."""
    rs = np.random.RandomState(0)
    xs = np.stack([rs.randn(10).astype(np.float32) for _ in range(64)])
    return xs, np.asarray([float(i % 4 + 1) for i in range(64)])


def _cls_data():
    rs = np.random.RandomState(0)
    return (rs.randn(32, 8, 16).astype(np.float32),
            np.asarray([float(i % 4 + 1) for i in range(32)]))


def _jax_model(name, cf=2.0):
    if name == "classifier":
        set_seed(3)
        return JTC(**CLS)
    set_seed(5)
    return jnn.Sequential(jnn.Linear(10, 12), jnn.ReLU(True),
                          jnn.MoE(12, 24, 4, capacity_factor=cf),
                          jnn.Linear(12, 4), jnn.LogSoftMax())


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_local(name, data, state, iters, cf=2.0):
    model = _jax_model(name, cf)
    xs, ys = data
    ds = JDataSet.array([JSample(x, np.asarray([y]))
                         for x, y in zip(xs, ys)]) >> JSampleToBatch(16)
    opt = JLocalOptimizer(model, ds, jnn.ClassNLLCriterion())
    opt.set_state(JT(**state))
    opt.set_end_when(jmax_iteration(iters))
    set_seed(5)   # the epoch order
    opt.optimize()
    return _numpy(model.params()), float(opt.state["loss"])


def _spec(name, data, mesh, state=MOM, iters=4, cf=2.0, ep=True, **kw):
    xs, ys = data
    arch = CLS if name == "classifier" else {"capacity_factor": cf}
    spec = dict(model=name, arch=arch,
                init=_numpy(_jax_model(name, cf).params()), xs=xs, ys=ys,
                batch=16, seed=5, iters=iters, mesh=mesh, state=state,
                kw={"expert_parallel": True} if ep else {})
    spec.update(kw)
    return spec


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


WD = dict(MOM, weightDecay=1e-3)


@pytest.fixture(scope="module")
def world4():
    ep = {"data": 2, "expert": 2}
    specs = {
        "ep": _spec("moe", _moe_data(), ep),
        "ep_wd": _spec("moe", _moe_data(), ep, state=WD),
        "ep_drop": _spec("moe", _moe_data(), ep, cf=0.5),
        "ep_one_slice": _spec("moe", _moe_data(), {"data": 1, "expert": 4},
                              cf=0.5),
        "ep_classifier": _spec("classifier", _cls_data(), ep,
                               state={"learningRate": 0.1}, iters=6),
        "dp_drop": _spec("moe", _moe_data(), {"data": 4}, cf=0.5, ep=False),
    }
    names = list(specs)
    per_rank = launch(W.runs, 4, "gloo", args=([specs[k] for k in names],))
    return [dict(zip(names, r)) for r in per_rank]


@pytest.fixture(scope="module")
def world2():
    specs = {"dp_drop": _spec("moe", _moe_data(), {"data": 2}, cf=0.5,
                              ep=False),
             "dp_bf16": _spec("moe", _moe_data(), {"data": 2}, cf=0.5,
                              ep=False, iters=1,
                              kw={"gradient_compression": "bf16"})}
    specs.update(_ignore_specs())
    names = list(specs)
    per_rank = launch(W.runs, 2, "gloo", args=([specs[k] for k in names],))
    return [dict(zip(names, r)) for r in per_rank]


@pytest.mark.parametrize("name,state,cf", [("ep", MOM, 2.0),
                                           ("ep_wd", WD, 2.0),
                                           ("ep_drop", MOM, 0.5),
                                           ("ep_one_slice", MOM, 0.5)])
def test_expert_parallel_matches_the_local_run(world4, name, state, cf):
    """test_expert_parallel_matches_replicated at {"data": 2, "expert":
    2} (and one data slice over 4 expert ranks), with weight decay, and
    at a capacity that drops tokens: the loss and every parameter, on
    every rank, the rows a rank does not own brought from their owner."""
    params, loss = _jax_local("moe", _moe_data(), state, 4, cf)
    for rank in world4:
        run = rank[name]
        assert abs(run["loss"][-1] - loss) < LOSS_TOL
        assert_trees(run["params"], params, **TOL)


def test_classifier_with_moe_blocks_matches_the_local_run(world4):
    """test_transformer_moe_blocks_train_expert_parallel, held to the
    local run: six steps of the MoE classifier."""
    params, loss = _jax_local("classifier", _cls_data(),
                              {"learningRate": 0.1}, 6)
    for rank in world4:
        run = rank["ep_classifier"]
        assert abs(run["loss"][-1] - loss) < LOSS_TOL
        assert_trees(run["params"], params, **TOL)
        assert run["coords"]["expert"] == rank["ep"]["coords"]["expert"]


def test_only_expert_stacked_leaves_are_owner_sharded(world4):
    """The sharding tree names the MoE's w1 b1 w2 b2 alone; each rank's
    velocity holds every other leaf whole and 1/e of the expert rows,
    and the exported velocity is the whole tree, the same on every
    rank."""
    for r, rank in enumerate(world4):
        run = rank["ep"]
        assert run["coords"] == {"data": r // 2, "expert": r % 2}
        moe = run["specs"]["2"]["~"]
        assert moe == {"router": None, "w1": "expert", "b1": "expert",
                       "w2": "expert", "b2": "expert"}
        assert run["specs"]["0"]["~"] == {"weight": None, "bias": None}
        sizes = {k: v.size for k, v in run["params"]["2"]["~"].items()}
        total = sum(v.size for _, v in
                    jax.tree_util.tree_leaves_with_path(run["params"]))
        expert = sum(sizes[k] for k in ("w1", "b1", "w2", "b2"))
        assert run["velocity_numel"] == total - expert + expert // 2
        assert_trees(run["opt_state"], world4[0]["ep"]["opt_state"],
                     rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_under_plain_data_parallelism_gates_the_global_batch(
        world, world2, world4):
    """nn.MoE under plain DP at 2 and 4 ranks, capacity 0.5: the
    capacity from the global token count and places offset by the ranks
    before, so the trajectory is the local run's."""
    params, loss = _jax_local("moe", _moe_data(), MOM, 4, 0.5)
    for rank in {2: world2, 4: world4}[world]:
        assert abs(rank["dp_drop"]["loss"][-1] - loss) < LOSS_TOL
        assert_trees(rank["dp_drop"]["params"], params, **TOL)


def test_the_bf16_wire_gates_each_rank_alone(world2):
    """On the compressed path the JAX shard_map builder gates each
    rank's tokens; so does the port: its first loss is the mean of the
    two halves' local runs, not the global batch's."""
    got = world2[0]["dp_bf16"]["loss"][0]
    _, glob = _jax_local("moe", _moe_data(), MOM, 1, 0.5)
    assert abs(got - glob) > 1e-4


@pytest.fixture(scope="module")
def world1():
    specs = {"ep": _spec("moe", _moe_data(), {"data": 1, "expert": 1}),
             "local": _spec("moe", _moe_data(), None, optimizer="local")}
    names = list(specs)
    return dict(zip(names, launch(W.runs, 1, "gloo",
                                  args=([specs[k] for k in names],))[0]))


def test_one_rank_is_local_optimizer_bit_for_bit(world1):
    got, want = world1["ep"], world1["local"]
    assert got["type"] == "DistriOptimizer" and got["world"] == 1
    assert got["loss"] == want["loss"]
    assert_trees(got["params"], want["params"], rtol=0, atol=0)


def _ds():
    xs, ys = _moe_data()
    return DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(16)


def test_validations_are_the_jax_words():
    """tests/test_moe_layer.py:129-136's messages, and the straggler
    drop's."""
    with pytest.raises(ValueError, match=re.escape(
            "expert_parallel needs a mesh with an 'expert' axis")):
        DistriOptimizer(W.build("moe"), _ds(), nn.ClassNLLCriterion(),
                        expert_parallel=True, device="cpu")
    words = re.escape(
        "expert_parallel composes with data parallelism only (mesh "
        "{'data': d, 'expert': e}); tensor_parallel/zero1/"
        "gradient_compression/sequence_parallel assume replicated or "
        "data-sharded params, not expert-sharded ones")
    with pytest.raises(ValueError, match=words):
        DistriOptimizer(W.build("moe"), _ds(), nn.ClassNLLCriterion(),
                        expert_parallel=True, zero1=True, device="cpu")
    with pytest.raises(ValueError, match=words):
        DistriOptimizer(W.build("moe"), _ds(), nn.ClassNLLCriterion(),
                        expert_parallel=True, sequence_parallel=True,
                        device="cpu")


def test_straggler_drop_refuses_expert_parallelism():
    kind, text = launch(W.refusal_case, 1, "gloo", args=(
        _spec("moe", _moe_data(), {"data": 1, "expert": 1}, iters=1,
              drop=dict(drop_percentage=0.1, max_drop_percentage=0.1)),))[0]
    assert kind == "ValueError"
    assert text.startswith("straggler drop masks per-DATA-replica")


# -- the ignore label on the plain path ------------------------------------

IGNORE = 2


def _ignore_data():
    """(N, 8) features and (N, 3) 1-based classes of four, a third of
    them the ignore label, unevenly over the ranks' halves."""
    rs = np.random.RandomState(3)
    xs = rs.randn(32, 8).astype(np.float32)
    ys = rs.randint(1, 5, (32, 3)).astype(np.float64)
    ys[:8][rs.rand(8, 3) < 0.7] = IGNORE
    return xs, ys


def _jax_softmax_model():
    set_seed(7)
    return jnn.Sequential(jnn.Linear(8, 12), jnn.Reshape([4, 3]))


def _ignore_specs():
    xs, ys = _ignore_data()
    return {"ignore": dict(model="softmax",
                           init=_numpy(_jax_softmax_model().params()),
                           xs=xs, ys=ys, batch=16, seed=5, iters=4,
                           state=MOM, criterion="softmax_ignore",
                           ignore_label=IGNORE)}


def test_softmax_ignore_label_takes_the_global_count(world2):
    """The plain path normalises by the positions kept over the whole
    batch (an all-reduced count): the JAX DistriOptimizer's step."""
    model = _jax_softmax_model()
    xs, ys = _ignore_data()
    ds = JDataSet.array([JSample(x, y) for x, y in zip(xs, ys)]) \
        >> JSampleToBatch(16)
    opt = JDistriOptimizer(model, ds,
                           jnn.SoftmaxWithCriterion(ignore_label=IGNORE),
                           mesh=data_parallel_mesh(jax.devices()[:2]))
    opt.set_state(JT(**MOM))
    opt.set_end_when(jmax_iteration(4))
    set_seed(5)
    opt.optimize()
    for rank in world2:
        run = rank["ignore"]
        np.testing.assert_allclose(run["loss"][-1], float(opt.state["loss"]),
                                   rtol=1e-4, atol=1e-5)
        assert_trees(run["params"], _numpy(model.params()), rtol=1e-4,
                     atol=1e-5)
