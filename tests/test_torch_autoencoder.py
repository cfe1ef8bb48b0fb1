"""examples/train_autoencoder.py on the port: ``Autoencoder(32)`` trained
with ``MSECriterion`` through ``LocalOptimizer`` on records that
``FuncTransformer`` builds (pixels / 255, flattened to 784, as both the
feature and the label), SGD at learningRate 0.01 and momentum 0.9,
against the same loop of the JAX package from the same parameters and
the same record order: three steps at one step a dispatch and as one
chunk of three, the losses and the final parameters.  Then the float
labels reach the criterion as the batch holds them, every update goes
through ``ops.fused_sgd``, and ``FuncTransformer`` equals the JAX one
and stays on the prefetch producer.  Held at rtol 1e-4 / atol 1e-5 (the JAX
trajectory tests' tolerance)."""
import threading

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.dataset.transformer import FuncTransformer as JaxFunc
from bigdl_tpu.dataset.transformer import SampleToBatch as JaxToBatch
from bigdl_tpu.models import autoencoder as jax_autoencoder
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, FuncTransformer, Sample,
                                     SampleToBatch, mnist)
from bigdl_tpu_torch.dataset import prefetch as pf
from bigdl_tpu_torch.models import autoencoder
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration
from bigdl_tpu_torch.optim import optim_method
from bigdl_tpu_torch.utils.table import T
from tests.helpers.torch_parity import keep_torch_rng  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
N_IMAGES, BATCH = 64, 16


def _flat(img):
    return (img.data / 255.0).astype(np.float32).reshape(-1)


def _jax_sample(img):
    flat = _flat(img)
    return JaxSample(flat, flat)


def _sample(img):
    flat = _flat(img)
    return Sample(flat, flat)


def _init(seed):
    set_seed(seed)
    return jax_autoencoder.Autoencoder(32)


def _jax_run(steps, n, seed=3):
    """The example's loop in the JAX package: ``steps`` iterations, n a
    dispatch."""
    jm = _init(seed)
    jds = (JaxDataSet.array(jax_mnist.synthetic(N_IMAGES, 5))
           >> JaxFunc(_jax_sample) >> JaxToBatch(BATCH))
    jopt = JaxLocalOptimizer(jm, jds, jnn.MSECriterion())
    jopt.set_state(JaxT(learningRate=0.01, momentum=0.9))
    jopt.set_end_when(jax_max_iteration(steps))
    jopt.set_iterations_per_dispatch(n)
    set_seed(seed)
    jopt.optimize()
    return jopt


def _port_run(steps, n, seed=3):
    """The same loop in the port, from the JAX model's initial
    parameters and with the same record order."""
    pm = autoencoder.Autoencoder(32, device="cpu")
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray,
                                               _init(seed).params()))
    pds = (DataSet.array(mnist.synthetic(N_IMAGES, 5), seed=seed)
           >> FuncTransformer(_sample) >> SampleToBatch(BATCH))
    popt = LocalOptimizer(pm, pds, nn.MSECriterion(), device="cpu")
    popt.set_state(T(learningRate=0.01, momentum=0.9))
    popt.set_end_when(max_iteration(steps))
    popt.set_iterations_per_dispatch(n)
    popt.optimize()
    return popt


@pytest.mark.parametrize("n", [1, 3])
def test_three_steps_equal_the_jax_example(n):
    """The losses (at one step a dispatch each step's, against JAX runs
    of 1, 2 and 3 steps: the JAX loop keeps only the last) and the final
    parameters."""
    popt = _port_run(3, n)
    jopt = _jax_run(3, n)
    assert popt.state["neval"] == jopt.state["neval"] == 4
    got = [l for _, l in popt.loss_log]
    assert len(got) == 3 and np.isfinite(got).all() and got[0] != got[-1]
    want = ([_jax_run(k, 1).state["loss"] for k in (1, 2)] if n == 1
            else []) + [jopt.state["loss"]]
    np.testing.assert_allclose(got[-len(want):], want, **TOL)
    want = jax.tree_util.tree_leaves(jopt.model.params())
    have = jax.tree_util.tree_leaves(export_params(popt.model))
    assert len(have) == len(want) == 4
    for a, b in zip(have, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_float_labels_reach_the_criterion_unchanged():
    """The (B, 784) float32 labels go to the criterion as the batch holds
    them: the same dtype, shape and values as the features."""
    seen = []

    class Spy(nn.MSECriterion):
        def apply_loss(self, input, target):
            seen.append(target.clone())
            return super().apply_loss(input, target)

    recs = mnist.synthetic(32, 5)
    ds = (DataSet.array(recs, seed=1) >> FuncTransformer(_sample)
          >> SampleToBatch(BATCH))
    first = next(iter(ds.data(train=False)))
    opt = LocalOptimizer(autoencoder.Autoencoder(32, device="cpu"), ds,
                         Spy(), device="cpu")
    opt.set_end_when(max_iteration(2)).optimize()
    assert len(seen) == 2
    for t in seen:
        assert t.dtype == torch.float32 and t.shape == (BATCH, 784)
        assert float(t.min()) >= 0 and float(t.max()) <= 1
    flats = {_flat(r).tobytes() for r in recs}
    assert all(row.numpy().tobytes() in flats for t in seen for row in t)
    assert first.labels.dtype == np.float32
    np.testing.assert_array_equal(first.labels, first.data)


def test_every_update_goes_through_fused_sgd(monkeypatch):
    calls = []
    real = optim_method.fused_sgd

    def spy(params, *args, **kwargs):
        calls.append(len(params))
        return real(params, *args, **kwargs)

    monkeypatch.setattr(optim_method, "fused_sgd", spy)
    ds = (DataSet.array(mnist.synthetic(32, 5), seed=1)
          >> FuncTransformer(_sample) >> SampleToBatch(BATCH))
    opt = LocalOptimizer(autoencoder.Autoencoder(32, device="cpu"), ds,
                         nn.MSECriterion(), device="cpu")
    opt.set_state(T(learningRate=0.01, momentum=0.9))
    opt.set_end_when(max_iteration(5)).optimize()
    assert calls == [4] * 5


def test_func_transformer_equals_the_jax_one():
    recs = mnist.synthetic(8, 2)
    jrecs = jax_mnist.synthetic(8, 2)
    got = list(FuncTransformer(_sample)(iter(recs)))
    want = list(JaxFunc(_jax_sample)(iter(jrecs)))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)


def test_func_transformer_stays_on_the_prefetch_producer():
    """The prefetch cannot see that ``fn`` is pure, so the stage is not a
    pure per-record stage: with workers configured nothing fans out, the
    function runs on the producer thread alone, and the batches are the
    workerless run's."""
    threads = set()

    def fn(img):
        threads.add(threading.get_ident())
        return _sample(img)

    def run(n_workers):
        threads.clear()
        ds = (DataSet.array(mnist.synthetic(48, 4), seed=9)
              >> FuncTransformer(fn) >> SampleToBatch(BATCH))
        runner = pf.PipelineRunner(ds, train=True, epoch_size=48,
                                   n_workers=n_workers)
        got = [np.array(runner.get()[0].x) for _ in range(5)]
        runner.close()
        return got, runner._split, set(threads), runner._producer.ident

    assert not FuncTransformer(fn).pure_per_record
    assert not pf._is_pure_map(FuncTransformer(fn))
    serial, _, _, _ = run(0)
    fanned, split, ran_on, producer = run(3)
    assert split is None and ran_on == {producer}
    for a, b in zip(serial, fanned):
        np.testing.assert_array_equal(a, b)
