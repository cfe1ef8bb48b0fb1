"""The Torch-style ``Module`` API of the port (bigdl_tpu_torch/nn/
module.py) against the JAX ``Module``'s (bigdl_tpu/nn/module.py:229-382)
on the CPU: ``update_output``, ``backward``, ``update_grad_input`` and
``acc_grad_parameters`` against the JAX methods (``jax.vjp``) on an MLP,
a conv net with a pool and a batch-normalised net; ``grads`` /
``load_grads`` / ``zero_grad_parameters``; ``get_parameters`` and
``n_parameters`` (LeNet-5, Inception-v1, VGG-16 and ResNet-50 at full
width, counted); ``reset`` (by bounds and moments: the random streams
differ); ``clone_module``; ``save`` read by the JAX ``File``; the
lifecycle methods; and the two names that stay PyTorch's,
``parameters()`` and ``training``.

The JAX parameters are loaded into the port; inputs come from numpy at a
seed.  Tolerance rtol 1e-5, atol 1e-6 (f32 sums in another order).
"""
import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import file as JaxFile
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.utils.random import RNG, generator

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(kind):
    """(JAX model, port model with its parameters, input shape)."""
    set_seed(11)
    if kind == "mlp":
        jm = jnn.Sequential(jnn.Linear(6, 12), jnn.Tanh(), jnn.Linear(12, 4),
                            jnn.LogSoftMax())
        pm = nn.Sequential(nn.Linear(6, 12), nn.Tanh(), nn.Linear(12, 4),
                           nn.LogSoftMax())
        shape = (5, 6)
    elif kind == "conv":
        jm = jnn.Sequential(jnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1),
                            jnn.ReLU(), jnn.SpatialMaxPooling(2, 2, 2, 2),
                            jnn.Reshape([4 * 4 * 4]), jnn.Linear(64, 3))
        pm = nn.Sequential(nn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1),
                           nn.ReLU(), nn.SpatialMaxPooling(2, 2, 2, 2),
                           nn.Reshape([4 * 4 * 4]), nn.Linear(64, 3))
        shape = (3, 2, 8, 8)
    else:
        jm = jnn.Sequential(jnn.Linear(6, 8), jnn.BatchNormalization(8),
                            jnn.ReLU(), jnn.Linear(8, 3))
        pm = nn.Sequential(nn.Linear(6, 8),
                           nn.BatchNormalization(8, device="cpu"),
                           nn.ReLU(), nn.Linear(8, 3))
        shape = (7, 6)
    load_jax_params(pm, _np(jm.params()))
    return jm, pm, shape


def _inputs(shape, out_shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*out_shape).astype(np.float32))


def _out_shape(kind, shape):
    return (shape[0], 4 if kind == "mlp" else 3)


def _assert_tree(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(_np(got))
    b = jax.tree_util.tree_leaves_with_path(_np(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _port_tree(tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


KINDS = ["mlp", "conv", "bn"]


@pytest.mark.parametrize("kind", KINDS)
def test_backward_matches_jax(kind):
    """``update_output`` then ``backward`` (twice: the gradients add up)
    against the JAX ``forward`` / ``backward``: the output, gradInput and
    every parameter's gradient; the running statistics moved once."""
    jm, pm, shape = _models(kind)
    x, gy = _inputs(shape, _out_shape(kind, shape))
    jy = jm.forward(jax.numpy.asarray(x))
    jgx = jm.backward(jax.numpy.asarray(x), jax.numpy.asarray(gy))
    jgx = jm.backward(jax.numpy.asarray(x), jax.numpy.asarray(gy))
    y = pm.update_output(torch.from_numpy(x))
    assert pm.output is y
    gx = pm.backward(torch.from_numpy(x), torch.from_numpy(gy))
    gx = pm.backward(torch.from_numpy(x), torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    assert pm.grad_input is gx
    _assert_tree(_port_tree(pm.grads()), jm.grads(), **TOL)
    if kind == "bn":
        # one forward moved the statistics, the backward's replay did not
        np.testing.assert_allclose(
            pm.get(2).running_mean.numpy(),
            np.asarray(jm.state()["1"]["~"]["running_mean"]), **TOL)
    assert pm.backward_time > 0 and pm.forward_time > 0


@pytest.mark.parametrize("kind", KINDS)
def test_update_grad_input_and_acc_grad_parameters_match_jax(kind):
    jm, pm, shape = _models(kind)
    x, gy = _inputs(shape, _out_shape(kind, shape), 1)
    jx, jgy = jax.numpy.asarray(x), jax.numpy.asarray(gy)
    jm.forward(jx)
    jgx = jm.update_grad_input(jx, jgy)
    pm.update_output(torch.from_numpy(x))
    pm.zero_grad_parameters()
    gx = pm.update_grad_input(torch.from_numpy(x), torch.from_numpy(gy))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    # no parameter's gradient moved
    assert all(float(p.grad.abs().max()) == 0 for p in pm.parameters())
    jm.acc_grad_parameters(jx, jgy)
    pm.acc_grad_parameters(torch.from_numpy(x), torch.from_numpy(gy))
    _assert_tree(_port_tree(pm.grads()), jm.grads(), **TOL)


def test_grads_tree_load_and_zero():
    jm, pm, _ = _models("mlp")
    assert all(float(np.abs(v).max()) == 0
               for v in jax.tree_util.tree_leaves(_port_tree(pm.grads())))
    tree = jax.tree_util.tree_map(lambda a: np.full_like(a, 2.0),
                                  export_params(pm))
    pm.load_grads(tree)
    assert all(torch.equal(p.grad, torch.full_like(p, 2.0))
               for p in pm.parameters())
    kept = [p.grad for p in pm.parameters()]
    pm.zero_grad_parameters()
    assert all(g is p.grad and float(g.abs().max()) == 0
               for g, p in zip(kept, pm.parameters()))


@pytest.mark.parametrize("kind", KINDS)
def test_get_parameters_matches_jax(kind):
    jm, pm, shape = _models(kind)
    x, gy = _inputs(shape, _out_shape(kind, shape), 2)
    jm.forward(jax.numpy.asarray(x))
    jm.backward(jax.numpy.asarray(x), jax.numpy.asarray(gy))
    pm.update_output(torch.from_numpy(x))
    pm.backward(torch.from_numpy(x), torch.from_numpy(gy))
    w, g = pm.get_parameters()
    jw, jg = jm.get_parameters()
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    assert pm.n_parameters() == jm.n_parameters() == w.numel()
    # snapshots, not views
    w.zero_()
    assert float(pm.get_parameters()[0].abs().max()) > 0


@pytest.mark.parametrize("name", ["lenet5", "inception_v1", "vgg16",
                                  "resnet50"])
def test_n_parameters_at_full_width(name):
    """The parameter count of each model at its published width equals
    the JAX model's (the port's on the meta device: counted only)."""
    from bigdl_tpu.models import (Inception_v1 as JInception, LeNet5 as JLeNet,
                                  ResNet as JResNet, Vgg_16 as JVgg16)
    from bigdl_tpu_torch.models import Inception_v1, LeNet5, ResNet, Vgg_16

    build = {"lenet5": (lambda: JLeNet(10),
                        lambda: LeNet5(10, device="meta")),
             "inception_v1": (lambda: JInception(1000),
                              lambda: Inception_v1(1000, device="meta")),
             "vgg16": (lambda: JVgg16(1000), lambda: Vgg_16(1000,
                                                            device="meta")),
             "resnet50": (lambda: JResNet(50, 1000),
                          lambda: ResNet(50, 1000, device="meta"))}[name]
    jm, pm = build[0](), build[1]()
    assert pm.n_parameters() == jm.n_parameters()
    assert pm.n_parameters() == {"lenet5": 22278, "inception_v1": 6998552,
                                 "vgg16": 138357544,
                                 "resnet50": 25557032}[name]


RESET_CASES = {
    "linear": (lambda g: nn.Linear(40, 30, generator=g),
               lambda: jnn.Linear(40, 30)),
    "conv": (lambda g: nn.SpatialConvolution(8, 16, 3, 3, generator=g),
             lambda: jnn.SpatialConvolution(8, 16, 3, 3)),
    "dilated": (lambda g: nn.SpatialDilatedConvolution(
        4, 8, 3, 3, device="cpu", generator=g),
        lambda: jnn.SpatialDilatedConvolution(4, 8, 3, 3)),
    "full": (lambda g: nn.SpatialFullConvolution(4, 8, 3, 3, device="cpu",
                                                 generator=g),
             lambda: jnn.SpatialFullConvolution(4, 8, 3, 3)),
    "bilinear": (lambda g: nn.Bilinear(5, 6, 7, device="cpu", generator=g),
                 lambda: jnn.Bilinear(5, 6, 7)),
    "cmul": (lambda g: nn.CMul((3, 50), device="cpu", generator=g),
             lambda: jnn.CMul((3, 50))),
    "cadd": (lambda g: nn.CAdd((3, 50), device="cpu", generator=g),
             lambda: jnn.CAdd((3, 50))),
    "add": (lambda g: nn.Add(60, device="cpu", generator=g),
            lambda: jnn.Add(60)),
    "cosine": (lambda g: nn.Cosine(20, 30, device="cpu", generator=g),
               lambda: jnn.Cosine(20, 30)),
    "euclidean": (lambda g: nn.Euclidean(20, 30, device="cpu", generator=g),
                  lambda: jnn.Euclidean(20, 30)),
    "lookup": (lambda g: nn.LookupTable(50, 16, device="cpu", generator=g),
               lambda: jnn.LookupTable(50, 16)),
    "lstm": (lambda g: nn.LSTMCell(10, 20, device="cpu", generator=g),
             lambda: jnn.LSTMCell(10, 20)),
    "gru": (lambda g: nn.GRUCell(10, 20, device="cpu", generator=g),
            lambda: jnn.GRUCell(10, 20)),
    "rnn": (lambda g: nn.RnnCell(10, 20, device="cpu", generator=g),
            lambda: jnn.RnnCell(10, 20)),
    "attention": (lambda g: nn.MultiHeadSelfAttention(16, 4, device="cpu",
                                                      generator=g),
                  lambda: jnn.MultiHeadSelfAttention(16, 4)),
    "moe": (lambda g: nn.MoE(8, 16, 4, device="cpu", generator=g),
            lambda: jnn.MoE(8, 16, 4)),
    "bn": (lambda g: nn.BatchNormalization(64, device="cpu", generator=g),
           lambda: jnn.BatchNormalization(64)),
    "mul": (lambda g: nn.Mul(device="cpu", generator=g), lambda: jnn.Mul()),
    "conv_map": (lambda g: nn.SpatialConvolutionMap(
        nn.SpatialConvolutionMap.full(4, 6), 3, 3, device="cpu",
        generator=g), lambda: jnn.SpatialConvolutionMap(
        jnn.SpatialConvolutionMap.full(4, 6), 3, 3)),
    "layer_norm": (lambda g: nn.LayerNorm(16, device="cpu"),
                   lambda: jnn.LayerNorm(16)),
    "prelu": (lambda g: nn.PReLU(5, device="cpu"), lambda: jnn.PReLU(5)),
}


@pytest.mark.parametrize("name", sorted(RESET_CASES))
def test_reset_redraws_within_the_jax_initialisers_bounds(name):
    """``reset`` keeps every parameter's shape, device and storage, moves
    the drawn values, and stays within the JAX initialiser's bounds: each
    leaf's range within the JAX leaf's (a uniform draw's bound, with 10%
    slack for a normal's tails) and, for a leaf of at least 256 values,
    its mean and spread near the JAX leaf's.  A constant leaf (a zero
    bias) equals the JAX one."""
    port, jax_build = RESET_CASES[name]
    module = port(generator(5))
    set_seed(5)
    want = _np(jax_build().params())["~"]
    before = {k: p.detach().clone() for k, p in module.named_parameters()}
    ptrs = {k: p.data_ptr() for k, p in module.named_parameters()}
    module.reset(generator(6))
    for k, p in module.named_parameters():
        assert p.shape == before[k].shape and p.data_ptr() == ptrs[k]
        got, ref = p.detach().numpy(), want[k]
        assert got.shape == ref.shape
        if np.ptp(ref) == 0 and ref.size > 1:
            np.testing.assert_array_equal(got, ref)
            continue
        assert not np.array_equal(got, before[k].numpy())
        # one draw of U(-1, 1) bounds nothing: the initialiser's own bound
        span = 1.0 if name == "mul" else np.abs(ref).max()
        assert np.abs(got).max() <= 1.1 * span
        if got.size >= 256:
            assert abs(got.mean() - ref.mean()) <= 0.1 * span
            assert abs(got.std() - ref.std()) <= 0.1 * ref.std()


def test_reset_restarts_running_statistics_and_walks_containers():
    model = nn.Sequential(nn.Linear(4, 6, generator=generator(0)),
                          nn.BatchNormalization(6, device="cpu"))
    model(torch.randn(8, 4))
    assert float(model.get(2).running_mean.abs().max()) > 0
    w = model.get(1).weight.detach().clone()
    assert model.reset() is model
    assert not torch.equal(model.get(1).weight, w)
    assert torch.equal(model.get(2).running_mean, torch.zeros(6))
    assert torch.equal(model.get(2).running_var, torch.ones(6))


def test_clone_module_is_independent():
    _, pm, shape = _models("bn")
    x = torch.from_numpy(_inputs(shape, (1,))[0])
    pm.update_output(x)
    twin = pm.clone_module()
    assert twin.output is None          # the kept output is not copied
    for a, b in zip(pm.parameters(), twin.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with torch.no_grad():
        next(twin.parameters()).add_(1.0)
    twin(x)
    assert not torch.equal(next(pm.parameters()), next(twin.parameters()))
    assert not torch.equal(pm.get(2).running_mean, twin.get(2).running_mean)


def test_save_is_read_by_the_jax_file(tmp_path):
    jm, pm, shape = _models("bn")
    pm(torch.from_numpy(_inputs(shape, (1,))[0]))   # moves the statistics
    assert pm.save(str(tmp_path / "m")) is pm
    fresh = jnn.Sequential(jnn.Linear(6, 8), jnn.BatchNormalization(8),
                           jnn.ReLU(), jnn.Linear(8, 3))
    JaxFile.load_module_into(fresh, str(tmp_path / "m"))
    _assert_tree(fresh.params(), export_params(pm), rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(fresh.state()["1"]["~"]["running_mean"]),
        pm.get(2).running_mean.numpy())
    with pytest.raises(FileExistsError):
        pm.save(str(tmp_path / "m"), overwrite=False)


def test_predict_mode_times_and_state():
    """``predict`` runs in evaluation mode without gradients and puts the
    mode back; ``is_training`` reads torch's flag; ``forward_time`` and
    ``get_times`` cover each module; ``reset_times`` and ``clear_state``
    clear them."""
    jm, pm, shape = _models("bn")
    x = _inputs(shape, (1,))[0]
    jm.evaluate()
    want = np.asarray(jm.forward(jax.numpy.asarray(x)))
    pm.train()
    out = pm.predict(torch.from_numpy(x))
    assert pm.is_training() and pm.training is True
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    times = pm.get_times()
    assert [m for m, _, _ in times] == list(pm.modules())
    assert all(f > 0 for _, f, _ in times)
    pm.reset_times()
    assert all(f == 0 and b == 0 for _, f, b in pm.get_times())
    pm.update_output(torch.from_numpy(x))
    pm.backward(torch.from_numpy(x), torch.ones(shape[0], 3))
    assert pm.output is not None and pm.grad_input is not None
    pm.clear_state()
    assert pm.output is None and pm.grad_input is None
    pm.evaluate()
    assert not pm.is_training()


def test_parameters_and_training_stay_torchs():
    """The documented differences from the JAX ``Module``: its
    ``parameters()`` returns ``(weights, grads)`` and its ``training()``
    is a method; the port keeps torch's iterator and flag (the
    optimizers and layers read them)."""
    jm, pm, _ = _models("mlp")
    ws, gs = jm.parameters()
    assert isinstance(ws, list) and isinstance(gs, list)
    ps = pm.parameters()
    assert not isinstance(ps, tuple)
    assert [tuple(p.shape) for p in ps] == [w.shape for w in ws]
    assert callable(jm.training) and isinstance(pm.training, bool)


def test_backward_replays_the_forwards_dropout_mask():
    """``backward`` runs the forward again: it draws the masks
    ``update_output`` drew, and leaves the stream where it was."""
    RNG.set_seed(3)
    model = nn.Sequential(nn.Dropout(0.5), nn.Linear(10, 4,
                                                     generator=generator(1)))
    x = torch.randn(6, 10)
    y = model.update_output(x)
    after = RNG.generator(x.device).get_state()
    gy = torch.randn(6, 4)
    gx = model.backward(x, gy)
    assert torch.equal(RNG.generator(x.device).get_state(), after)
    # the gradient through the same mask: W^T gy where the mask kept x
    xx = x.clone().requires_grad_(True)
    RNG.generator(x.device).set_state(model._replay)
    yy = model(xx)
    assert torch.equal(yy, y)
    yy.backward(gy)
    np.testing.assert_allclose(gx.numpy(), xx.grad.numpy(), **TOL)


def test_a_table_input():
    model = nn.CAddTable()
    a, b = torch.randn(3, 4), torch.randn(3, 4)
    from bigdl_tpu_torch.utils.table import Table

    gx = model.backward(Table(a, b), torch.ones(3, 4))
    assert isinstance(gx, Table) and len(gx) == 2
    assert torch.equal(gx[1], torch.ones(3, 4))
