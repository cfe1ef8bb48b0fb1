"""The rest of the training harness under the port's ``DistriOptimizer``
on gloo ranks (the CPU): ``Adagrad`` under plain data parallelism,
``zero1``, tensor parallelism and the pipeline (the port of
tests/test_pipeline_optimizer.py:346-357 ``test_pipeline_with_adagrad``),
each held against ``LocalOptimizer``'s run of the same global batches and
the plain run against the JAX ``DistriOptimizer``; SGD's per-parameter
learning rates under plain data parallelism and tensor parallelism; and
``DistriValidator`` / ``Validator`` / ``distri_validate`` on two ranks
against ``LocalValidator`` and the JAX ``Validator``; and
``SampleToBatch(global_batch_size=)`` over the live world.

Tolerances: tests/test_distributed.py's (rtol 1e-4, atol 1e-5) for the
trajectories; the pipeline's tests/test_pipeline_optimizer.py:95-96
(loss within 1e-5, params rtol 2e-5, atol 2e-6); validation counts
exact, the loss rtol 1e-5.
"""
import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.optim import Adagrad as JaxAdagrad
from bigdl_tpu.optim import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.optim import Loss as JaxLoss
from bigdl_tpu.optim import Top1Accuracy as JaxTop1
from bigdl_tpu.optim import Top5Accuracy as JaxTop5
from bigdl_tpu.optim import Validator as JaxValidator
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.parallel.mesh import data_parallel_mesh
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.nn.module import load_jax_params
from bigdl_tpu_torch.optim import (LocalValidator, Loss, Top1Accuracy,
                                   Top5Accuracy)
from bigdl_tpu_torch.parallel.launch import launch
from tests.helpers import torch_distri_workers as W

TOL = dict(rtol=1e-4, atol=1e-5)
PIPE_LOSS_ATOL = 1e-5
PIPE_TOL = dict(rtol=2e-5, atol=2e-6)
ADA = {"learningRate": 0.1, "learningRateDecay": 0.01}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(n=64, d=8, classes=4):
    """tests/test_distributed.py:124-130."""
    rng = np.random.RandomState(0)
    w = rng.randn(d, classes)
    xs = rng.randn(n, d).astype(np.float32)
    return xs, (xs @ w).argmax(1) + 1.0


def _jax_mlp():
    set_seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4),
                          jnn.LogSoftMax())


def _jax_mlp_pp():
    """tests/test_pipeline_optimizer.py's ``_mlp``."""
    set_seed(7)
    return jnn.Sequential(
        jnn.Linear(12, 32), jnn.ReLU(True), jnn.Linear(32, 32), jnn.Tanh(),
        jnn.Linear(32, 16), jnn.ReLU(True), jnn.Linear(16, 5),
        jnn.LogSoftMax())


def _pp_data(n=64):
    rs = np.random.RandomState(0)
    xs = rs.randn(n, 12).astype(np.float32)
    return xs, np.asarray([float(i % 5 + 1) for i in range(n)])


def _spec(**kw):
    xs, ys = _data()
    spec = dict(model="mlp", init=_np(_jax_mlp().params()), xs=xs, ys=ys,
                batch=32, seed=5, iters=4, state=ADA, method="adagrad")
    spec.update(kw)
    return spec


def _rates(init):
    """Rates 0 (the first Linear's weight), 0.5 and 2."""
    scales = jax.tree_util.tree_map(np.ones_like, init)
    scales["0"]["~"]["weight"] = np.zeros_like(init["0"]["~"]["weight"])
    scales["0"]["~"]["bias"] = np.full_like(init["0"]["~"]["bias"], 0.5)
    scales["2"]["~"]["weight"] = np.full_like(init["2"]["~"]["weight"], 2.0)
    return scales


def assert_trees(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(got)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _world2_specs():
    init = _np(_jax_mlp().params())
    sgd = {"learningRate": 0.1, "momentum": 0.9,
           "learningRates": _rates(init)}
    return {
        "local": _spec(optimizer="local"),
        "plain": _spec(),
        "zero1": _spec(kw={"zero1": True}),
        "tp": _spec(mesh={"data": 1, "model": 2},
                    kw={"tensor_parallel": True}),
        "local_rates": _spec(optimizer="local", state=sgd, method=None),
        "plain_rates": _spec(state=sgd, method=None),
        "tp_rates": _spec(state=sgd, method=None,
                          mesh={"data": 1, "model": 2},
                          kw={"tensor_parallel": True}),
    }


@pytest.fixture(scope="module")
def world2():
    specs = _world2_specs()
    names = list(specs)
    xs, ys = _data(40)
    val = dict(model="mlp", init=_np(_jax_mlp().params()), xs=xs, ys=ys,
               batch=8)
    per_rank = launch(W.calls, 2, "gloo", args=([
        (W.runs, ([specs[k] for k in names],)),
        (W.validator_case, (val,)),
        (W.global_batch_case, (xs, ys, 8))],))
    return {"runs": [dict(zip(names, r[0])) for r in per_rank],
            "validators": [r[1] for r in per_rank], "val": val,
            "global_batch": [r[2] for r in per_rank]}


@pytest.fixture(scope="module")
def world4():
    xs, ys = _pp_data()
    base = dict(model="mlp_pp", init=_np(_jax_mlp_pp().params()), xs=xs,
                ys=ys, batch=16, seed=5, iters=3, method="adagrad",
                state={"learningRate": 0.1})
    specs = {"local": dict(base, optimizer="local"),
             "pipe": dict(base, mesh={"pipe": 4},
                          kw={"pipeline_stages": 4,
                              "pipeline_microbatches": 4}),
             "hybrid": dict(base, mesh={"data": 2, "pipe": 2},
                            kw={"pipeline_stages": 2,
                                "pipeline_microbatches": 4})}
    names = list(specs)
    per_rank = launch(W.runs, 4, "gloo", args=([specs[k] for k in names],))
    return [dict(zip(names, r)) for r in per_rank]


def _jax_adagrad_dp(n=2):
    model = _jax_mlp()
    xs, ys = _data()
    ds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                           for x, y in zip(xs, ys)]) >> JaxSampleToBatch(32)
    opt = JaxDistriOptimizer(model, ds, jnn.ClassNLLCriterion(),
                             mesh=data_parallel_mesh(jax.devices()[:n]))
    opt.set_optim_method(JaxAdagrad())
    opt.set_state(JaxT(**ADA))
    opt.set_end_when(jax_max_iteration(4))
    set_seed(5)
    opt.optimize()
    return _np(model.params()), float(opt.state["loss"])


@pytest.mark.parametrize("mode", ["plain", "zero1", "tp"])
def test_adagrad_under_distri_matches_local(world2, mode):
    """Adagrad on two ranks (plain, ``zero1``'s flat slices, tensor
    parallelism's rows): the losses, params and optimizer state (the
    variance tree and the int32 step, one on every rank) equal
    ``LocalOptimizer``'s over the same global batches."""
    for rank in world2["runs"]:
        run, local = rank[mode], rank["local"]
        assert run["type"] == "DistriOptimizer"
        np.testing.assert_allclose(run["loss"], local["loss"], **TOL)
        assert_trees(run["params"], local["params"], **TOL)
        assert set(run["opt_state"]) == {"variance", "step"}
        assert_trees(run["opt_state"]["variance"],
                     local["opt_state"]["variance"], **TOL)
        assert int(run["opt_state"]["step"]) == 4
        assert np.asarray(run["opt_state"]["step"]).dtype == np.int32


def test_adagrad_plain_dp_matches_jax(world2):
    jparams, jloss = _jax_adagrad_dp()
    for rank in world2["runs"]:
        assert_trees(rank["plain"]["params"], jparams, **TOL)
        np.testing.assert_allclose(rank["plain"]["loss"][-1], jloss, **TOL)


@pytest.mark.parametrize("mode", ["plain_rates", "tp_rates"])
def test_learning_rates_under_dp_and_tp_match_local(world2, mode):
    """``state['learningRates']`` under plain DP and under TP (each rank
    its rows of a sharded leaf's rates): LocalOptimizer's trajectory; the
    zero-rate weight never moves."""
    init = _np(_jax_mlp().params())
    for rank in world2["runs"]:
        run, local = rank[mode], rank["local_rates"]
        np.testing.assert_allclose(run["loss"], local["loss"], **TOL)
        assert_trees(run["params"], local["params"], **TOL)
        np.testing.assert_array_equal(run["params"]["0"]["~"]["weight"],
                                      init["0"]["~"]["weight"])


@pytest.mark.parametrize("mode", ["pipe", "hybrid"])
def test_pipeline_with_adagrad(world4, mode):
    """tests/test_pipeline_optimizer.py:346-357 on the port, and held to
    LocalOptimizer: Adagrad's step is a scalar every stage keeps whole
    while the variance lives in each stage's flat buffer (exported
    stage-stacked, as the JAX pipeline leaves it)."""
    for rank in world4:
        run, local = rank[mode], rank["local"]
        assert np.isfinite(run["loss"][-1])
        assert abs(run["loss"][-1] - local["loss"][-1]) < PIPE_LOSS_ATOL
        assert_trees(run["params"], local["params"], **PIPE_TOL)
        assert int(run["opt_state"]["step"]) == 3
        assert np.asarray(run["opt_state"]["variance"]).ndim == 2


def _results(values):
    return [(float(v), int(n)) for v, n in values]


def test_validators_on_two_ranks_equal_the_local_and_jax(world2):
    """``DistriValidator`` over a set every rank holds, the ``Validator``
    factory over a sharded set, and ``distri_validate``: each rank's
    merged Top1, Top5 and Loss equal ``LocalValidator`` on one process and
    the JAX ``Validator``."""
    val = world2["val"]
    model = load_jax_params(W.build("mlp"), val["init"])
    ds = DataSet.array([Sample(x, np.asarray([y]))
                        for x, y in zip(val["xs"], val["ys"])]) \
        >> SampleToBatch(val["batch"])
    local = _results(r.result() for _, r in LocalValidator(
        model, ds, device="cpu").test(
            [Top1Accuracy(), Top5Accuracy(), Loss(nn.ClassNLLCriterion())]))
    jm = _jax_mlp()
    jds = JaxDataSet.array([JaxSample(x, np.asarray([y]))
                            for x, y in zip(val["xs"], val["ys"])]) \
        >> JaxSampleToBatch(val["batch"])
    jres = _results(r.result() for _, r in JaxValidator(jm, jds).test(
        [JaxTop1(), JaxTop5(), JaxLoss(jnn.ClassNLLCriterion())]))
    assert [n for _, n in local] == [n for _, n in jres] == [40] * 3
    for (a, _), (b, _) in zip(local, jres):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for rank in world2["validators"]:
        for kind in ("distri", "factory", "function"):
            got = _results(rank[kind])
            assert [n for _, n in got] == [40] * 3
            assert got[:2] == local[:2]        # the accuracies: exact
            np.testing.assert_allclose(got[2][0], local[2][0], rtol=1e-5)


def test_global_batch_size_is_divided_over_the_live_world(world2):
    """``SampleToBatch(global_batch_size=8)`` on two ranks: batches of 4
    on each rank's shard of 20 records (the JAX ``_local_batch`` over
    ``jax.process_count()``)."""
    for rows in world2["global_batch"]:
        assert rows == [4] * 5
