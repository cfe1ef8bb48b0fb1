"""``DistriOptimizer(sequence_parallel=True)`` of the port under gloo,
held against the JAX ``DistriOptimizer(sequence_parallel=True)`` on a
mesh of the same shape (conftest's virtual CPU devices): the
``TransformerClassifier`` at ``{"data": 2, "seq": 2}`` and the LM with
``TimeDistributedCriterion`` (tests/test_transformer.py:63-82,
:257-296), the attention model of tests/test_attention_sp.py with n
steps a dispatch, a world of one against ``LocalOptimizer`` bit for
bit, the JAX validations word for word, and a time-mixing module
refused by name.  The ranks import the port alone
(``tests/helpers/torch_distri_workers.py``)."""
import re

import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.transformer import TransformerClassifier as JTC
from bigdl_tpu.models.transformer import TransformerLM as JLM
from bigdl_tpu.optim import DistriOptimizer as JDistriOptimizer
from bigdl_tpu.optim import max_iteration as jmax_iteration
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
from bigdl_tpu_torch.optim import DistriOptimizer
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W

TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_transformer.py:82, :296
CLS = dict(class_num=4, d_model=16, n_heads=2, n_layers=2, hidden=32,
           dropout=0.0)
LM = dict(vocab_size=8, d_model=16, n_heads=2, n_layers=1, hidden=32,
          dropout=0.0)


def _cls_data():
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 8, 16).astype(np.float32)
    return xs, np.asarray([float(i % 4 + 1) for i in range(32)])


def _lm_data():
    rs = np.random.RandomState(0)
    xs, ys = [], []
    for _ in range(32):
        xs.append(np.eye(8, dtype=np.float32)[rs.randint(0, 8, 8)])
        ys.append(rs.randint(0, 8, 8) + 1.0)
    return np.stack(xs), np.stack(ys)


def _jax_model(name):
    set_seed(3 if name == "classifier" else 17)
    if name == "classifier":
        return JTC(**CLS)
    if name == "lm":
        return JLM(**LM)
    return jnn.Sequential(jnn.MultiHeadSelfAttention(16, 4),
                          jnn.Mean(1, n_input_dims=2), jnn.Linear(16, 4),
                          jnn.LogSoftMax())


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_crit(kind):
    if kind == "tdc":
        return jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                            size_average=True)
    if kind == "tdc_sum":
        return jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    return jnn.ClassNLLCriterion()


def _jax_run(name, data, mesh, crit="nll", iters=6, lr=0.1):
    """The JAX DistriOptimizer(sequence_parallel=True) on ``mesh``."""
    model = _jax_model(name)
    xs, ys = data
    ds = JDataSet.array([JSample(x, y if np.ndim(y) else np.asarray([y]))
                         for x, y in zip(xs, ys)]) >> JSampleToBatch(16)
    jm = jax_make_mesh(mesh, jax.devices()[:int(np.prod(list(
        mesh.values())))])
    opt = JDistriOptimizer(model, ds, _jax_crit(crit), mesh=jm,
                           sequence_parallel=True)
    opt.set_state(JT(learningRate=lr))
    opt.set_end_when(jmax_iteration(iters))
    set_seed(5)   # the epoch order
    opt.optimize()
    return _numpy(model.params()), float(opt.state["loss"])


def _spec(name, data, mesh, crit="nll", **kw):
    xs, ys = data
    arch = {"classifier": CLS, "lm": LM}.get(name)
    spec = dict(model=name, arch=arch, init=_numpy(_jax_model(name).params()),
                xs=xs, ys=ys, batch=16, seed=5, iters=6, mesh=mesh,
                criterion=crit, state={"learningRate": 0.1},
                kw={"sequence_parallel": True})
    spec.update(kw)
    return spec


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def world4():
    mesh = {"data": 2, "seq": 2}
    specs = {
        "classifier": _spec("classifier", _cls_data(), mesh),
        "lm": _spec("lm", _lm_data(), mesh, crit="tdc", iters=5),
        "lm_sum": _spec("lm", _lm_data(), mesh, crit="tdc_sum", iters=3,
                        state={"learningRate": 0.01}),
        "attn_n2": _spec("attn", _cls_data(), {"data": 1, "seq": 4},
                         iters=4, n_disp=2),
        "attn_sharded": _spec("attn", _cls_data(), {"data": 1, "seq": 4},
                              iters=4, distributed=True),
        "attn_local": _spec("attn", _cls_data(), None, iters=4,
                            optimizer="local"),
    }
    names = list(specs)
    per_rank = launch(W.runs, 4, "gloo", args=([specs[k] for k in names],))
    return [dict(zip(names, r)) for r in per_rank]


@pytest.fixture(scope="module")
def world1():
    specs = {
        "classifier": _spec("classifier", _cls_data(), {"data": 1, "seq": 1}),
        "local": _spec("classifier", _cls_data(), None, optimizer="local"),
        "lm": _spec("lm", _lm_data(), {"data": 1, "seq": 1}, crit="tdc"),
        "lm_local": _spec("lm", _lm_data(), None, crit="tdc",
                          optimizer="local"),
    }
    names = list(specs)
    return dict(zip(names, launch(W.runs, 1, "gloo",
                                  args=([specs[k] for k in names],))[0]))


def test_classifier_matches_jax_sequence_parallel(world4):
    """test_transformer_trains_and_sp_matches_local at {"data": 2,
    "seq": 2}: six steps, the loss and every parameter against the JAX
    sequence-parallel run, and the ranks' coordinates row-major."""
    params, loss = _jax_run("classifier", _cls_data(),
                            {"data": 2, "seq": 2})
    for r, rank in enumerate(world4):
        run = rank["classifier"]
        assert run["coords"] == {"data": r // 2, "seq": r % 2}
        assert_trees(run["params"], params, **TOL)
        np.testing.assert_allclose(run["loss"][-1], loss, **TOL)
        assert len(run["loss"]) == 6


def test_lm_matches_jax_sequence_parallel(world4):
    """test_transformer_lm_sequence_parallel_matches_local: the causal LM
    with TimeDistributedCriterion(size_average=True), (B, T) targets
    sliced with the inputs, five steps."""
    params, loss = _jax_run("lm", _lm_data(), {"data": 2, "seq": 2},
                            crit="tdc", iters=5)
    for rank in world4:
        assert_trees(rank["lm"]["params"], params, **TOL)
        np.testing.assert_allclose(rank["lm"]["loss"][-1], loss, **TOL)


def test_lm_summed_over_time_matches_jax(world4):
    """TimeDistributedCriterion summing the steps: each rank's blocks
    count once (no 1/s time share)."""
    params, loss = _jax_run("lm", _lm_data(), {"data": 2, "seq": 2},
                            crit="tdc_sum", iters=3, lr=0.01)
    for rank in world4:
        assert_trees(rank["lm_sum"]["params"], params, **TOL)
        np.testing.assert_allclose(rank["lm_sum"]["loss"][-1], loss, **TOL)


def test_a_sharded_dataset_splits_by_the_data_coordinate(world4):
    """A sharded dataset under sequence parallelism: the ranks of one
    data slice take the same records (one slice here: every record, in
    the order of the replicated dataset's stream)."""
    for rank in world4:
        assert_trees(rank["attn_sharded"]["params"],
                     rank["attn_local"]["params"], **TOL)
        assert rank["attn_sharded"]["epoch"] == rank["attn_local"]["epoch"]


def test_chunked_dispatch_matches_local(world4):
    """test_sequence_parallel_chunked_dispatch at {"data": 1, "seq": 4}:
    two steps a dispatch (the eager loop) give the local trajectory."""
    for rank in world4:
        assert_trees(rank["attn_n2"]["params"], rank["attn_local"]["params"],
                     **TOL)
        assert len(rank["attn_n2"]["loss"]) == 4


@pytest.mark.parametrize("name,local", [("classifier", "local"),
                                        ("lm", "lm_local")])
def test_one_rank_is_local_optimizer_bit_for_bit(world1, name, local):
    got, want = world1[name], world1[local]
    assert got["type"] == "DistriOptimizer" and got["world"] == 1
    assert got["loss"] == want["loss"]
    assert_trees(got["params"], want["params"], rtol=0, atol=0)


# -- refusals -------------------------------------------------------------

def _ds():
    xs, ys = _cls_data()
    return DataSet.array(W.samples_of(xs, ys)) >> SampleToBatch(16)


def test_validations_are_the_jax_words():
    """tests/test_attention_sp.py:111-125's messages."""
    with pytest.raises(ValueError, match=re.escape(
            "sequence_parallel needs a mesh with 'data' and 'seq' axes "
            "(pure SP: use {'data': 1, 'seq': s})")):
        DistriOptimizer(W.build("attn"), _ds(), nn.ClassNLLCriterion(),
                        sequence_parallel=True, device="cpu")
    with pytest.raises(ValueError, match="composes with data parallelism "
                                         r"only \(mesh \{'data': d, "
                                         r"'seq': s\}\)"):
        DistriOptimizer(W.build("attn"), _ds(), nn.ClassNLLCriterion(),
                        sequence_parallel=True, zero1=True, device="cpu")
    with pytest.raises(ValueError, match="composes with data parallelism"):
        DistriOptimizer(W.build("attn"), _ds(), nn.ClassNLLCriterion(),
                        sequence_parallel=True,
                        gradient_compression="bf16", device="cpu")
    with pytest.raises(ValueError, match="composes with data parallelism "
                                         r"only \(mesh \{'data': d, "
                                         r"'seq': s\}\)"):
        DistriOptimizer(W.build("attn"), _ds(), nn.ClassNLLCriterion(),
                        sequence_parallel=True, tensor_parallel=True,
                        device="cpu")


def _refused(spec, n=1):
    """What rank 0 of an ``n``-rank run of ``spec`` raised: (type, text),
    or None."""
    return launch(W.refusal_case, n, "gloo", args=(spec,))[0]


def test_time_not_divisible_by_the_seq_axis_raises():
    """T = 6 over a seq axis of 4 (the JAX test's T 6 over 8): refused at
    the batch, in the JAX words; T = 8 over 4 trains."""
    rs = np.random.RandomState(0)
    xs = rs.randn(16, 6, 16).astype(np.float32)
    ys = np.ones(16)
    spec = dict(_spec("attn", (xs, ys), {"data": 1, "seq": 1}, iters=1),
                batch=8)
    # a seq axis of one rank divides every length: 6 trains
    assert _refused(spec) is None
    kind, text = _refused(dict(spec, mesh={"data": 1, "seq": 4}), 4)
    assert kind == "ValueError"
    assert "divisible by the seq axis (4); got shape (8, 6, 16)" in text


def test_a_time_mixing_module_raises_naming_itself():
    """A Recurrent under sequence_parallel would run over the block as
    over the whole sequence: refused, by name."""
    rs = np.random.RandomState(0)
    spec = dict(_spec("rnn", (rs.randn(16, 8, 16).astype(np.float32),
                              np.ones(16)), {"data": 1, "seq": 1}, iters=1),
                init=W.export_params(W.build("rnn")))
    kind, text = _refused(spec)
    assert kind == "NotImplementedError"
    assert text.startswith("Recurrent under sequence_parallel")
