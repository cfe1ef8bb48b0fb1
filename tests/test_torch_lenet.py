"""The port's training slice against the JAX package: ``LeNet5``
log-probs and parameter gradients, its layers, ``ClassNLLCriterion`` and
``CrossEntropyCriterion``, the validation methods, and a short
``LocalOptimizer`` run
(``SGD``, lr 0.05, momentum 0.9, as chip_smoke.py trains)
from the same parameters and the same batch order, then ``Top1Accuracy``
on one validation set.

Weights cross from the JAX model through ``nn.module.load_jax_params``.
The JAX pools run through their Mosaic kernel in interpret mode
(``_PALLAS_POOL = "interpret"``): its first-max tie rule is the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Top1Accuracy as JaxTop1
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim import validate as jax_validate
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import DataSet, ImgNormalizer, ImgToBatch, mnist
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, NonFiniteGradError,
                                   Optimizer, Top1Accuracy, max_iteration,
                                   validate)
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


@pytest.fixture()
def jax_model():
    set_seed(1)
    return JaxLeNet5(10)


def _port_model(jax_model):
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params())
    return load_jax_params(LeNet5(10, device="cpu"), tree)


def _assert_trees_close(got, want, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_param_tree_carries_across(jax_model):
    port = _port_model(jax_model)
    assert sum(p.numel() for p in port.parameters()) == 22278
    assert list(port._modules) == [str(i) for i in range(12)]
    assert port.get(2).name == "conv1_5x5"
    _assert_trees_close(export_params(port), jax_model.params(), rtol=0,
                        atol=0)


def test_log_probs_and_grads_match_jax(mosaic_pools, jax_model):
    """B=4 grey images as ImgToBatch gives them (B, 1, 28, 28) and as
    (B, 28, 28), which Reshape([1, 28, 28]) takes as a batch."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 1, 28, 28).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.float32)
    crit = jnn.ClassNLLCriterion()
    ctx = Context(training=True)

    def loss_fn(p):
        out, _ = jax_model.apply(p, jnp.asarray(x), jax_model.state(), ctx)
        return crit.apply_loss(out, jnp.asarray(y)), out

    (loss_j, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax_model.params())
    port = _port_model(jax_model)
    out = port(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    grads = {k: {"~": {n: p.grad for n, p in m._parameters.items()}}
             for k, m in port._modules.items()}
    _assert_trees_close(grads, grads_j, **TOL)
    with torch.no_grad():
        out3 = port(torch.from_numpy(x[:, 0]))
    np.testing.assert_allclose(out3.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("weights,size_average,target_shape", [
    (None, True, (5,)), (None, False, (5, 1)),
    ([0.5, 1.0, 2.0, 1.5], True, (5,)), ([0.5, 1.0, 2.0, 1.5], False, (5,)),
])
def test_criterions_match_jax(weights, size_average, target_shape):
    """1-based float targets; loss and gradient against the input."""
    rs = np.random.RandomState(1)
    logits = rs.randn(5, 4).astype(np.float32)
    target = (rs.randint(0, 4, 5) + 1).astype(np.float32).reshape(
        target_shape)
    for jc, pc in ((jnn.ClassNLLCriterion, nn.ClassNLLCriterion),
                   (jnn.CrossEntropyCriterion, nn.CrossEntropyCriterion)):
        inp = (np.array(jax.nn.log_softmax(logits))
               if jc is jnn.ClassNLLCriterion else logits)
        jcrit = jc(weights, size_average)
        pcrit = pc(weights, size_average)
        want = jcrit.forward(jnp.asarray(inp), jnp.asarray(target))
        got = pcrit.forward(torch.from_numpy(inp), torch.from_numpy(target))
        np.testing.assert_allclose(float(got), float(want), **TOL)
        np.testing.assert_allclose(
            pcrit.backward(torch.from_numpy(inp),
                           torch.from_numpy(target)).numpy(),
            np.asarray(jcrit.backward(jnp.asarray(inp), jnp.asarray(target))),
            **TOL)


def _mnist_set(pkg, n, seed, batch, shuffle_seed=1):
    if pkg == "jax":
        ds = JaxDataSet.array(jax_mnist.synthetic(n, seed))
        return ds >> JaxNormalizer(jax_mnist.TRAIN_MEAN,
                                   jax_mnist.TRAIN_STD) >> JaxToBatch(batch)
    ds = DataSet.array(mnist.synthetic(n, seed), seed=shuffle_seed)
    return ds >> ImgNormalizer(mnist.TRAIN_MEAN,
                               mnist.TRAIN_STD) >> ImgToBatch(batch)


def test_local_optimizer_trajectory_matches_jax(mosaic_pools, jax_model):
    """Four iterations over one shuffled epoch of 32 synthetic images in
    batches of 8, momentum 0.9 (dampening defaults to it), fused SGD:
    the final params, ``state['loss']`` and ``neval`` equal the JAX
    run's; then Top1 on one validation set is the same count."""
    port = _port_model(jax_model)
    state = dict(learningRate=0.05, momentum=0.9)

    jopt = JaxLocalOptimizer(jax_model, _mnist_set("jax", 32, 0, 8),
                             jnn.ClassNLLCriterion())
    jopt.set_optim_method(JaxSGD(fused=True)).set_state(JaxT(**state))
    jopt.set_end_when(jax_max_iteration(4))
    set_seed(5)   # the epoch order: the JAX shuffle draws from this stream
    jopt.optimize()

    popt = LocalOptimizer(port, _mnist_set("torch", 32, 0, 8, 5),
                          nn.ClassNLLCriterion(), device="cpu")
    popt.set_optim_method(SGD(fused=True)).set_state(T(**state))
    popt.set_end_when(max_iteration(4))
    popt.optimize()

    assert popt.state["neval"] == jopt.state["neval"] == 5
    assert popt.state["epoch"] == jopt.state["epoch"] == 2
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(port), jax_model.params(), **TOL)
    assert [n for n, _ in popt.loss_log] == [1, 2, 3, 4]
    assert popt.host_syncs == 1          # the epoch rollover's flush

    (_, want), = jax_validate(jax_model, jax_model.params(),
                              jax_model.state(),
                              _mnist_set("jax", 24, 1, 8), [JaxTop1()])
    (_, got), = validate(port, _mnist_set("torch", 24, 1, 8), [Top1Accuracy()],
                         "cpu")
    assert (got.correct, got.count) == (want.correct, want.count)


def test_nonfinite_step_is_skipped():
    """A batch that poisons the loss leaves every parameter as it was;
    the skip is counted when the window flushes."""
    model = LeNet5(10, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    images = mnist.synthetic(4, 0)
    images[0].data[0, 0] = np.nan
    ds = DataSet.array(images) >> ImgToBatch(4)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(fused=True))
    opt.set_state(T(learningRate=0.05, momentum=0.9))
    opt.set_end_when(max_iteration(1)).optimize()
    assert opt.state["nonFiniteSkips"] == 1
    assert np.isnan(opt.state["loss"])
    for p, b in zip(model.parameters(), before):
        assert torch.equal(p.detach(), b)


def test_gradients_persist_across_steps():
    """Each step zeroes the same ``.grad`` tensors in place (the SGD
    kernel's leaf table is keyed on their pointers) and leaves in them
    the gradient of its own batch alone."""
    model = LeNet5(10, device="cpu")
    opt = LocalOptimizer(model, _mnist_set("torch", 8, 0, 4, 1),
                         nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.05, momentum=0.9))
    opt.set_end_when(max_iteration(1)).optimize()
    ptrs = [p.grad.data_ptr() for p in model.parameters()]
    opt.set_end_when(max_iteration(3)).optimize()
    assert [p.grad.data_ptr() for p in model.parameters()] == ptrs
    kept = [p.grad.clone() for p in model.parameters()]
    params = list(model.parameters())
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 28, 28)
                         .astype(np.float32))
    y = torch.tensor([1.0, 2.0, 3.0, 4.0])
    opt._train_step(params, opt.optim_method.init_state(params), x, y,
                    {"lr": 0.0})
    fresh = LeNet5(10, device="cpu").load_params(model.params())
    nn.ClassNLLCriterion()(fresh(x), y).backward()
    for p, q, k in zip(params, fresh.parameters(), kept):
        torch.testing.assert_close(p.grad, q.grad, **TOL)
        assert not torch.equal(p.grad, k)


def test_cpu_training_counts_no_launch():
    ops.reset_launch_counts()
    opt = Optimizer(LeNet5(10, device="cpu"), _mnist_set("torch", 8, 0, 4, 1),
                    nn.ClassNLLCriterion(), optim_method=SGD(fused=True),
                    state=T(learningRate=0.05), end_trigger=max_iteration(2),
                    device="cpu")
    opt.optimize()
    assert set(ops.launch_counts().values()) == {0}
    assert opt.state["neval"] == 3


@pytest.mark.parametrize("build", [
    lambda: LeNet5(10),
    lambda: LocalOptimizer(LeNet5(10, device="cpu"), None, None),
    lambda: Optimizer(LeNet5(10, device="cpu"), None, None),
])
def test_entry_points_default_to_the_card(build):
    """Without a card the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_nonfinite_streak_aborts():
    images = mnist.synthetic(8, 0)
    for img in images:
        img.data[0, 0] = np.inf
    opt = LocalOptimizer(LeNet5(10, device="cpu"),
                         DataSet.array(images) >> ImgToBatch(4),
                         nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.05)).set_end_when(max_iteration(5))
    opt.set_nonfinite_policy(2)
    with pytest.raises(NonFiniteGradError, match="2 consecutive"):
        opt.optimize()
    assert opt.state["nonFiniteSkips"] == 2


@pytest.mark.parametrize("args,shape", [
    ((3, 4, 3, 3), (2, 3, 9, 9)),
    ((4, 6, 3, 2, 2, 1, 1, 0, 2), (2, 4, 9, 8)),   # stride, pad, groups
    ((3, 2, 1, 1, 1, 1, 0, 0, 1, False), (3, 7, 7)),  # no bias, one CHW
])
def test_convolution_matches_jax(args, shape):
    """``SpatialConvolution`` (reference argument order) output and
    gradients against the JAX layer, TF32 off."""
    jm = jnn.SpatialConvolution(*args[:9], with_bias=(
        args[9] if len(args) > 9 else True))
    pm = nn.SpatialConvolution(*args)
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    rs = np.random.RandomState(4)
    x = rs.randn(*shape).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    g = rs.randn(*want.shape).astype(np.float32)
    ctx = Context(training=True)
    dp_j, dx_j = jax.grad(lambda p, v: (jm.apply(p, v, {"~": {}}, ctx)[0]
                                        * g).sum(), argnums=(0, 1))(
        jm.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    for k, p in pm._parameters.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(dp_j["~"][k]),
                                   **TOL)


@pytest.mark.parametrize("size,batch_mode,shape", [
    ([1, 28, 28], None, (3, 28, 28)), ([1, 28, 28], None, (1, 28, 28)),
    ([12 * 4 * 4], None, (5, 12, 4, 4)), ([6, 2], False, (3, 4)),
    ([4], True, (2, 2, 2)),
])
def test_reshape_and_tanh_match_jax(size, batch_mode, shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = jnn.Reshape(size, batch_mode).forward(jnp.asarray(x))
    got = nn.Reshape(size, batch_mode)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(nn.Tanh()(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.Tanh().forward(jnp.asarray(x))),
                               **TOL)


def test_validation_methods_match_jax():
    from bigdl_tpu.optim import Loss as JaxLoss
    from bigdl_tpu.optim import Top5Accuracy as JaxTop5
    from bigdl_tpu_torch.optim import Loss, Top5Accuracy

    rs = np.random.RandomState(6)
    out = np.array(jax.nn.log_softmax(rs.randn(9, 10).astype(np.float32)))
    target = (rs.randint(0, 10, 9) + 1).astype(np.float32)
    for jm, pm in ((JaxTop1(), Top1Accuracy()), (JaxTop5(), Top5Accuracy())):
        want = jm(jnp.asarray(out), target) + jm(jnp.asarray(out[:4]),
                                                  target[:4])
        got = pm(torch.from_numpy(out), target) + pm(torch.from_numpy(
            out[:4]), target[:4])
        assert got.result() == want.result()
    want = JaxLoss(jnn.ClassNLLCriterion())(jnp.asarray(out),
                                            jnp.asarray(target))
    got = Loss(nn.ClassNLLCriterion())(torch.from_numpy(out), target)
    assert got.count == want.count == 9
    np.testing.assert_allclose(got.result()[0], want.result()[0], **TOL)
