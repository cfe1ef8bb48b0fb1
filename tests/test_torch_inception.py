"""The port's Inception-v1 slice against the JAX package: the full
``Inception_v1(1000)`` parameter tree, one ``inception_module`` and a
few-layer mini-Inception built from the same blocks (stem with both LRNs,
strided and stride-1 pools, ``Concat``, ``SpatialAveragePooling``,
``View``, ``Linear``, ``LogSoftMax``) forward and backward, the layers
the slice adds, and a short ``LocalOptimizer`` run with
examples/train_inception.py's SGD state over its crop/flip/normalise
pipeline.

Weights cross from the JAX model through ``nn.module.load_jax_params``.
The JAX pools run through their Mosaic kernel in interpret mode
(``_PALLAS_POOL = "interpret"``), whose first-max tie rule is the port's.
The JAX ``Concat`` runs its merged 1x1 heads (the same math as the port's
branch-by-branch ``Concat``, summed in another order), so forward and
gradients are held at rtol 1e-4 / atol 1e-5, as the LeNet tests are.
Dropout's p is 0 wherever the two packages train: their masks come from
different generators.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.image import HFlip as JaxHFlip
from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
from bigdl_tpu.dataset.image import ImgRdmCropper as JaxCropper
from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
from bigdl_tpu.dataset.image import LabeledImage as JaxImage
from bigdl_tpu.models import inception as jax_inception
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim.optim_method import Poly as JaxPoly
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, LabeledImage)
from bigdl_tpu_torch.models import inception
from bigdl_tpu_torch.nn.module import export_params, load_jax_params
from bigdl_tpu_torch.optim import LocalOptimizer, Poly, max_iteration
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)
MEAN, STD = (123.0, 117.0, 104.0), (1.0, 1.0, 1.0)   # train_inception.py


@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


def _tree(m):
    return jax.tree_util.tree_map(np.asarray, m.params())


def _assert_trees_close(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _grads(module):
    """The parameter gradients of a port model in the nested tree."""
    tree = {"~": {k: p.grad for k, p in module._parameters.items()}}
    for name, m in module._modules.items():
        tree[name] = _grads(m)
    return tree


def _mini(pkg, classes=10, p=0.4, **dev):
    """The network's layer kinds at narrow widths over 64x64 inputs:
    64 -> conv s2 32 -> pool s2 16 -> two blocks -> pool s2 8 -> block ->
    pool s2 4 -> block -> 4x4 average -> 1."""
    m = (jnn if pkg == "jax" else nn).Sequential()
    mod = jax_inception if pkg == "jax" else inception
    conv, block = mod._conv, mod.inception_module
    N = jnn if pkg == "jax" else nn
    m.add(conv(3, 8, 7, 7, 2, 2, 3, 3, **dev))
    m.add(N.ReLU(True))
    m.add(N.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(N.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(conv(8, 8, 1, 1, **dev))
    m.add(N.ReLU(True))
    m.add(conv(8, 12, 3, 3, 1, 1, 1, 1, **dev))
    m.add(N.ReLU(True))
    m.add(N.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(block(12, 4, 4, 6, 2, 3, 3, **dev))       # -> 16
    m.add(block(16, 6, 4, 6, 2, 4, 4, **dev))       # -> 20
    m.add(N.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(20, 6, 6, 8, 2, 4, 4, **dev))       # -> 22
    m.add(N.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(22, 8, 6, 8, 2, 4, 4, **dev))       # -> 24
    m.add(N.SpatialAveragePooling(4, 4, 1, 1))
    m.add(N.Dropout(p))
    m.add(N.View(24))
    m.add(N.Linear(24, classes, **dev))
    m.add(N.LogSoftMax())
    return m


def test_param_tree_carries_across():
    """116 leaves, 6,998,552 parameters, the same paths and shapes; the
    JAX tree goes in and comes out unchanged."""
    set_seed(1)
    jm = jax_inception.Inception_v1(1000)
    port = inception.Inception_v1(1000, device="cpu")
    want = _tree(jm)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(export_params(port))
    assert [(k, v.shape) for k, v in got_leaves] == [
        (k, v.shape) for k, v in leaves]
    assert len(leaves) == 116
    assert sum(p.numel() for p in port.parameters()) == 6998552
    load_jax_params(port, want)
    _assert_trees_close(export_params(port), want, rtol=0, atol=0)
    assert port.get(1).name == "conv1/7x7_s2"
    assert port.get(25).name == "loss3/classifier"


def test_inception_module_matches_jax(mosaic_pools):
    set_seed(2)
    jm = jax_inception.inception_module(8, 4, 4, 6, 2, 3, 3)
    pm = load_jax_params(inception.inception_module(
        8, 4, 4, 6, 2, 3, 3, device="cpu"), _tree(jm))
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 9, 9).astype(np.float32)
    ctx = Context(training=True)
    y_jax = jm.forward(jnp.asarray(x))
    g = rs.randn(*y_jax.shape).astype(np.float32)
    dp_j, dx_j = jax.grad(lambda p, v: (jm.apply(p, v, jm.state(), ctx)[0]
                                        * g).sum(), argnums=(0, 1))(
        jm.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert tuple(y.shape) == (2, 16, 9, 9)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    _assert_trees_close(_grads(pm), dp_j, **TOL)


def test_mini_inception_log_probs_and_grads_match_jax(mosaic_pools):
    set_seed(4)
    jm = _mini("jax")
    pm = load_jax_params(_mini("torch", device="cpu"), _tree(jm))
    for m in (jm, pm):
        m.get(17).set_p(0.0)
    rs = np.random.RandomState(5)
    x = rs.randn(4, 3, 64, 64).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.float32)
    crit = jnn.ClassNLLCriterion()
    ctx = Context(training=True)

    def loss_fn(p):
        out, _ = jm.apply(p, jnp.asarray(x), jm.state(), ctx)
        return crit.apply_loss(out, jnp.asarray(y)), out

    (loss_j, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jm.params())
    out = pm(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    assert tuple(out.shape) == (4, 10)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)
    # evaluation mode takes the primal kernels' path: no residuals
    pm.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(out_j), **TOL)


def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0, 255, (size, size, 3)), rs.randint(1, 11))
            for _ in range(n)]


def test_local_optimizer_trajectory_matches_jax(mosaic_pools):
    """Four iterations of the mini model over one epoch of 16 images of
    72x72, randomly cropped to 64, flipped and normalised as
    examples/train_inception.py does, in batches of 4, with the example's
    SGD state (weight decay, momentum 0.9, dampening 0, Poly(0.5, 4)) but
    a learning rate of 0.01: at the example's 0.0898 the narrow model on
    pixels of +-128 diverges (loss 2.58 -> 101 -> 1.90 -> 30.0 in both
    packages), and float rounding grows past any tolerance.  The final
    parameters, ``state['loss']`` and ``neval`` equal the JAX run's after
    ``set_seed``."""
    set_seed(6)
    jm = _mini("jax")
    pm = load_jax_params(_mini("torch", device="cpu"), _tree(jm))
    for m in (jm, pm):
        m.get(17).set_p(0.0)
    recs = _images(16, 72, 7)

    def state(t, poly):
        return t(learningRate=0.01, weightDecay=1e-4, momentum=0.9,
                 dampening=0.0, learningRateSchedule=poly(0.5, 4))

    jds = (JaxDataSet.array([JaxImage(d, lbl) for d, lbl in recs])
           >> JaxCropper(64, 64) >> JaxHFlip() >> JaxNormalizer(MEAN, STD)
           >> JaxToBatch(4))
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_state(state(JaxT, JaxPoly)).set_end_when(jax_max_iteration(4))
    set_seed(8)   # the shuffles, crops and flips draw from this stream
    jopt.optimize()

    pds = (DataSet.array([LabeledImage(d, lbl) for d, lbl in recs], seed=8)
           >> ImgRdmCropper(64, 64) >> HFlip() >> ImgNormalizer(MEAN, STD)
           >> ImgToBatch(4))
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_state(state(T, Poly)).set_end_when(max_iteration(4))
    popt.optimize()

    assert popt.state["neval"] == jopt.state["neval"] == 5
    assert popt.state["epoch"] == jopt.state["epoch"] == 2
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(pm), jm.params(), **TOL)


@pytest.mark.parametrize("args", [
    (7, 7, 1, 1),                                  # Inception's head
    (3, 3, 2, 2, 0, 0, True),                      # ceil overhang counted
    (3, 2, 2, 1, 1, 1, True, False),               # real elements only
    (2, 2, 2, 2, 0, 0, False, True, False),        # the window sum
])
def test_average_pooling_matches_jax(args):
    """The divisor counts the padding and a ceil-mode overhang, as the JAX
    module's does (and ``F.avg_pool2d(ceil_mode=True)`` does not)."""
    x = np.random.RandomState(9).randn(2, 3, 7, 8).astype(np.float32)
    want = np.asarray(jnn.SpatialAveragePooling(*args).forward(
        jnp.asarray(x)))
    got = nn.SpatialAveragePooling(*args)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    one = nn.SpatialAveragePooling(*args)(torch.from_numpy(x[0]))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sizes,shape", [
    ((1024,), (3, 1024, 1, 1)), ((1024,), (1, 1024, 1, 1)),
    ((6, 2), (12,)), ((4,), (2, 2, 2)),
])
def test_view_matches_jax(sizes, shape):
    x = np.random.RandomState(10).randn(*shape).astype(np.float32)
    want = jnn.View(*sizes).forward(jnp.asarray(x))
    got = nn.View(*sizes)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_view_with_num_input_dims_batches_extra_dims():
    v = nn.View(4).set_num_input_dims(3)
    assert tuple(v(torch.zeros(1, 2, 2, 1)).shape) == (1, 4)
    assert tuple(v(torch.zeros(2, 2, 1)).shape) == (4,)


def test_xavier_init_and_relu_in_place_flag():
    """Xavier draws U(+-sqrt(6/(fanIn+fanOut))) over (I/groups)*kh*kw and
    (O/groups)*kh*kw, with zero bias, as the JAX layer does; ReLU(True)
    computes what the JAX ReLU(True) does."""
    conv = nn.SpatialConvolution(64, 192, 3, 3, init_method=nn.Xavier,
                                 device="cpu", generator=generator(0))
    bound = math.sqrt(6.0 / (64 * 9 + 192 * 9))
    w = conv.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
    assert float(w.mean().abs()) < 0.01 * bound
    assert torch.equal(conv.bias.detach(), torch.zeros(192))
    set_seed(0)
    jw = np.asarray(jnn.SpatialConvolution(
        64, 192, 3, 3, init_method=jnn.Xavier).params()["~"]["weight"])
    assert np.abs(jw).max() <= bound and np.abs(jw).max() > 0.99 * bound
    again = nn.SpatialConvolution(64, 192, 3, 3, init_method=nn.Xavier,
                                  generator=generator(0))
    assert torch.equal(again.weight.detach(), w)
    with pytest.raises(ValueError, match="no init method"):
        nn.SpatialConvolution(1, 1, 1, 1, init_method="bilinearfiller")
    x = np.random.RandomState(11).randn(3, 5).astype(np.float32)
    relu = nn.ReLU(True)
    assert relu.inplace
    np.testing.assert_array_equal(
        relu(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.ReLU(True).forward(jnp.asarray(x))))


def test_cpu_model_counts_no_launch():
    ops.reset_launch_counts()
    m = inception.Inception_v1_NoAuxClassifier(10, device="cpu",
                                               generator=generator(0))
    x = torch.randn(1, 3, 224, 224, generator=generator(1))
    out = m(x)
    assert tuple(out.shape) == (1, 10)
    assert bool(torch.isfinite(out).all())
    out.sum().backward()
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("build", [
    lambda: inception.Inception_v1(1000),
    lambda: inception.inception_module(8, 4, 4, 6, 2, 3, 3),
])
def test_entry_points_default_to_the_card(build):
    """Without a card the model factories raise unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
