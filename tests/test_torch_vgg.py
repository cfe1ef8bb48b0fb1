"""The port's VGG slice against the JAX package: the full
``VggForCifar10(10)``, ``Vgg_16`` and ``Vgg_19`` parameter and state
trees (no forward), a few-layer mini-VGG built from the same
``conv-BN-ReLU`` blocks (five 2x2 s2 ceil pools, ``Dropout``, ``View``,
``Linear``, ``BatchNormalization``, ``LogSoftMax``) forward and backward
in training and evaluation, and a short ``LocalOptimizer`` run with
examples/train_vgg.py's pipeline and SGD state, losses, parameters and
running statistics alike; ``cifar.synthetic`` and ``load_bin`` beside the
JAX reader's.

Weights and state cross from the JAX model through the tree carriers.
The JAX pools run through their Mosaic kernel in interpret mode (its
first-max tie rule is the port's: after BN and ReLU a 2x2 window of
exact zeros is common, and the JAX default route splits the tied
gradient).  Dropout's p is 0 wherever the two packages train: their
masks come from different generators.  Held at rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import cifar as jax_cifar
from bigdl_tpu.dataset.image import HFlip as JaxHFlip
from bigdl_tpu.dataset.image import ImgNormalizer as JaxNormalizer
from bigdl_tpu.dataset.image import ImgRdmCropper as JaxCropper
from bigdl_tpu.dataset.image import ImgToBatch as JaxToBatch
from bigdl_tpu.models import vgg as jax_vgg
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, cifar)
from bigdl_tpu_torch.models import vgg
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)
from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture()
def mosaic_pools(monkeypatch):
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _grads(module):
    tree = {"~": {k: p.grad for k, p in module._parameters.items()}}
    for name, m in module._modules.items():
        tree[name] = _grads(m)
    return tree


def _shapes(tree):
    return [(k, np.shape(v))
            for k, v in jax.tree_util.tree_leaves_with_path(_np(tree))]


@pytest.mark.parametrize("name,n_params,n_leaves,n_state", [
    ("VggForCifar10", 14991946, 58, 9472),
    ("Vgg_16", 138357544, 32, 0),
    ("Vgg_19", 143667240, 38, 0),
])
def test_full_model_trees_carry_across(name, n_params, n_leaves, n_state):
    """The same paths and shapes of parameters and state as the JAX
    model; the JAX trees go in and come out unchanged (no forward)."""
    set_seed(1)
    jm = getattr(jax_vgg, name)(10 if name == "VggForCifar10" else 1000)
    pm = getattr(vgg, name)(10 if name == "VggForCifar10" else 1000,
                            device="cpu")
    assert _shapes(export_params(pm)) == _shapes(jm.params())
    assert _shapes(export_state(pm)) == _shapes(jm.state())
    assert len(jax.tree_util.tree_leaves(export_params(pm))) == n_leaves
    assert sum(p.numel() for p in pm.parameters()) == n_params
    assert sum(b.numel() for b in pm.buffers()) == n_state
    if name == "VggForCifar10":
        load_jax_params(pm, _np(jm.params()))
        load_jax_state(pm, _np(jm.state()))
        _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)
        _assert_trees_close(export_state(pm), jm.state(), rtol=0, atol=0)


def _mini(pkg, classes=10, **dev):
    """VggForCifar10's layer kinds at narrow widths over 32x32 inputs:
    32 -> pool 16 -> pool 8 -> pool 4 -> pool 2 -> pool 1."""
    N = jnn if pkg == "jax" else nn
    mod = jax_vgg if pkg == "jax" else vgg
    cbr = mod._conv_bn_relu
    m = N.Sequential()
    cbr(m, 3, 8, **dev).add(N.Dropout(0.3))
    cbr(m, 8, 8, **dev)
    m.add(N.SpatialMaxPooling(2, 2, 2, 2).ceil())
    cbr(m, 8, 12, **dev).add(N.Dropout(0.4))
    m.add(N.SpatialMaxPooling(2, 2, 2, 2).ceil())
    cbr(m, 12, 16, **dev)
    m.add(N.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(N.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(N.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(N.View(16))
    m.add(N.Dropout(0.5))
    m.add(N.Linear(16, 16, **dev))
    m.add(N.BatchNormalization(16, **dev))
    m.add(N.ReLU(True))
    m.add(N.Dropout(0.5))
    m.add(N.Linear(16, classes, **dev))
    m.add(N.LogSoftMax())
    return m


def _no_dropout(*models):
    for m in models:
        mods = m.modules() if isinstance(m, torch.nn.Module) else \
            _jax_modules(m)
        for d in mods:
            if isinstance(d, (nn.Dropout, jnn.Dropout)):
                d.set_p(0.0)


def _jax_modules(m):
    yield m
    for c in m._modules.values():
        yield from _jax_modules(c)


def _pair(seed):
    set_seed(seed)
    jm = _mini("jax")
    pm = _mini("torch", device="cpu")
    load_jax_params(pm, _np(jm.params()))
    load_jax_state(pm, _np(jm.state()))
    _no_dropout(jm, pm)
    return jm, pm


def test_mini_vgg_log_probs_grads_and_state_match_jax(mosaic_pools):
    jm, pm = _pair(2)
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 3, 32, 32) * 2).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.float32)
    crit = jnn.ClassNLLCriterion()

    def loss_fn(p):
        out, st = jm.apply(p, jnp.asarray(x), jm.state(),
                           Context(training=True))
        return crit.apply_loss(out, jnp.asarray(y)), (out, st)

    (loss_j, (out_j, state_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(jm.params())
    ops.reset_launch_counts()
    out = pm(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    assert set(ops.launch_counts().values()) == {0}   # plain on the CPU
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)
    _assert_trees_close(export_state(pm), state_j, **TOL)
    # evaluation reads the running statistics the step left
    want, _ = jm.apply(jm.params(), jnp.asarray(x), state_j,
                       Context(training=False))
    pm.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), **TOL)


def test_cifar_synthetic_is_the_jax_data():
    for n, seed in ((16, 0), (5, 1)):
        got, want = cifar.synthetic(n, seed), jax_cifar.synthetic(n, seed)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.data, np.asarray(b.data))
            assert a.label == float(b.label)
    assert cifar.TRAIN_MEAN == jax_cifar.TRAIN_MEAN
    assert cifar.TRAIN_STD == jax_cifar.TRAIN_STD


def test_load_bin_native_and_numpy_bits(tmp_path):
    """A ``.bin`` written here: the C decoder and its numpy twin give the
    same bits, and the JAX reader's values."""
    rs = np.random.RandomState(4)
    n = 37
    rec = np.empty((n, 3073), np.uint8)
    rec[:, 0] = rs.randint(0, 10, n)
    rec[:, 1:] = rs.randint(0, 256, (n, 3072))
    path = tmp_path / "data_batch_1.bin"
    rec.tofile(path)
    imgs, labels = cifar.load_bin(str(path))
    imgs_np, labels_np = cifar.load_bin(str(path), native_decode=False)
    assert imgs.dtype == labels.dtype == np.float32
    assert imgs.shape == (n, 32, 32, 3)
    assert imgs.tobytes() == imgs_np.tobytes()
    assert labels.tobytes() == labels_np.tobytes()
    np.testing.assert_array_equal(labels, rec[:, 0].astype(np.float32))
    np.testing.assert_array_equal(
        imgs[5, 7, 9], rec[5, 1 + np.arange(3) * 1024 + 7 * 32 + 9])
    j_imgs, j_labels = jax_cifar.load_bin(str(path))
    np.testing.assert_array_equal(imgs, j_imgs)
    np.testing.assert_array_equal(labels, j_labels)
    with pytest.raises(ValueError, match="whole CIFAR records"):
        from bigdl_tpu_torch import native
        native.cifar_decode(np.zeros(3074, np.uint8))


def test_load_reads_the_folder(tmp_path):
    rs = np.random.RandomState(5)
    rec = rs.randint(0, 256, (3, 3073)).astype(np.uint8)
    rec[:, 0] = [0, 9, 4]
    rec.tofile(tmp_path / "test_batch.bin")
    got = cifar.load(str(tmp_path), training=False)
    assert [r.label for r in got] == [1.0, 10.0, 5.0]
    with pytest.raises(FileNotFoundError):
        cifar.load(str(tmp_path), training=True)


def test_local_optimizer_trajectory_matches_jax(mosaic_pools):
    """Four iterations of the mini model over one epoch of 16 synthetic
    CIFAR images, normalised, padded by 4 and cropped back to 32 at
    random, flipped, in batches of 4 (examples/train_vgg.py's chain),
    with the example's SGD state (lr 0.01, momentum 0.9, weight decay
    5e-4).  The losses, parameters and running statistics equal the JAX
    run's."""
    jm, pm = _pair(6)
    norm = (cifar.TRAIN_MEAN, cifar.TRAIN_STD)
    jds = (JaxDataSet.array(jax_cifar.synthetic(16, 7)) >> JaxNormalizer(*norm)
           >> JaxCropper(32, 32, padding=4) >> JaxHFlip() >> JaxToBatch(4))
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_state(JaxT(learningRate=0.01, momentum=0.9, weightDecay=5e-4))
    jopt.set_end_when(jax_max_iteration(4))
    set_seed(8)   # the shuffles, crops and flips draw from this stream
    jopt.optimize()
    pds = (DataSet.array(cifar.synthetic(16, 7), seed=8)
           >> ImgNormalizer(*norm) >> ImgRdmCropper(32, 32, padding=4)
           >> HFlip() >> ImgToBatch(4))
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_state(T(learningRate=0.01, momentum=0.9, weightDecay=5e-4))
    popt.set_end_when(max_iteration(4))
    popt.optimize()
    assert popt.state["neval"] == jopt.state["neval"] == 5
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(pm), jm.params(), **TOL)
    _assert_trees_close(export_state(pm), jm.state(), **TOL)
    assert float(pm.get(2).running_var.sub(1).abs().max()) > 0.1


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for build in (vgg.VggForCifar10, vgg.Vgg_16, vgg.Vgg_19):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_same_generator_same_model():
    a = vgg.VggForCifar10(10, device="cpu", generator=generator(0))
    b = vgg.VggForCifar10(10, device="cpu", generator=generator(0))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
