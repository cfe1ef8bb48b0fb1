"""The rest of the port's model zoo against the JAX package: the full
``Inception_v2(1000)``, ``AlexNet``, ``AlexNet_OWT`` and ``Autoencoder``
parameter and state trees; a narrow BN-Inception built from
``inception_v2_module`` (the average branch, the stride-2 max block that
passes its pool through, the stride-1 max block) forward and backward in
training and evaluation; ``AlexNet`` (grouped convolutions, both LRNs,
three 3x3 s2 pools) and ``AlexNet_OWT`` log-probs and gradients at batch
2; the ``Autoencoder``'s reconstruction and gradients.

Weights and state cross from the JAX model through the tree carriers;
the JAX pools run through their Mosaic kernel in interpret mode (the
port's first-max tie rule).  Dropout's p is 0.  Held at rtol 1e-4 / atol
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import alexnet as jax_alexnet
from bigdl_tpu.models import autoencoder as jax_autoencoder
from bigdl_tpu.models import inception as jax_inception
from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.models import alexnet, autoencoder, inception
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)

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


@pytest.mark.parametrize("name,build,n_params,n_leaves,n_state", [
    ("Inception_v2", lambda pkg, **d: pkg.Inception_v2(1000, **d),
     11204936, 278, 19904),
    ("AlexNet", lambda pkg, **d: pkg.AlexNet(1000, **d), 60965224, 16, 0),
    ("AlexNet_OWT", lambda pkg, **d: pkg.AlexNet_OWT(1000, **d), 61100840,
     16, 0),
    ("Autoencoder", lambda pkg, **d: pkg.Autoencoder(32, **d), 50992, 4, 0),
])
def test_full_model_trees_carry_across(name, build, n_params, n_leaves,
                                       n_state):
    set_seed(1)
    pkg = {"Inception_v2": (jax_inception, inception),
           "AlexNet": (jax_alexnet, alexnet),
           "AlexNet_OWT": (jax_alexnet, alexnet),
           "Autoencoder": (jax_autoencoder, autoencoder)}[name]
    jm = build(pkg[0])
    pm = build(pkg[1], device="cpu")
    assert _shapes(export_params(pm)) == _shapes(jm.params())
    assert _shapes(export_state(pm)) == _shapes(jm.state())
    assert len(jax.tree_util.tree_leaves(export_params(pm))) == n_leaves
    assert sum(p.numel() for p in pm.parameters()) == n_params
    assert sum(b.numel() for b in pm.buffers()) == n_state
    load_jax_params(pm, _np(jm.params()))
    _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)
    if name == "AlexNet":
        assert pm.get(1).name == "conv1" and pm.get(23).name == "fc8"
        assert pm.get(5).n_group == 2


def _mini_v2(pkg, **dev):
    """BN-Inception's layer kinds at narrow widths over 64x64 inputs: the
    stem (7x7 s2 conv-BN-ReLU, 3x3 s2 ceil pool) -> 16x16, an average
    block, a stride-2 max block (its pool passed through) -> 8x8, a
    stride-1 max block, the 8x8 average head."""
    N = jnn if pkg == "jax" else nn
    mod = jax_inception if pkg == "jax" else inception
    m = N.Sequential()
    m.add(mod._conv_bn(3, 8, 7, 7, 2, 2, 3, 3, **dev))
    m.add(N.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(mod.inception_v2_module(8, 4, 4, 4, 4, 6, 2, "avg", **dev))
    m.add(mod.inception_v2_module(16, 0, 4, 6, 4, 6, 0, "max", 2, **dev))
    m.add(mod.inception_v2_module(28, 4, 4, 4, 4, 4, 4, "max", **dev))
    m.add(N.SpatialAveragePooling(8, 8, 1, 1))
    m.add(N.View(16))
    m.add(N.Linear(16, 10, **dev))
    m.add(N.LogSoftMax())
    return m


def _log_probs_and_grads(jm, pm, x, y, training=True):
    """The JAX model's and the port's log-probs, NLL loss, gradients and
    state after one training forward, held at TOL."""
    crit = jnn.ClassNLLCriterion()

    def loss_fn(p):
        out, st = jm.apply(p, jnp.asarray(x), jm.state(),
                           Context(training=training))
        return crit.apply_loss(out, jnp.asarray(y)), (out, st)

    (loss_j, (out_j, state_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(jm.params())
    pm.train(training)
    out = pm(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)
    _assert_trees_close(export_state(pm), state_j, **TOL)
    return state_j


def test_mini_inception_v2_matches_jax(mosaic_pools):
    set_seed(2)
    jm = _mini_v2("jax")
    pm = _mini_v2("torch", device="cpu")
    load_jax_params(pm, _np(jm.params()))
    load_jax_state(pm, _np(jm.state()))
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 3, 64, 64) * 2).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.float32)
    state_j = _log_probs_and_grads(jm, pm, x, y)
    assert tuple(pm(torch.from_numpy(x)).shape) == (4, 10)
    want, _ = jm.apply(jm.params(), jnp.asarray(x), state_j,
                       Context(training=False))
    load_jax_state(pm, _np(state_j))
    pm.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), **TOL)


def test_inception_v2_pools_take_both_kernels_routes():
    """The stem pools and 3c/4e's stride-2 max pools are ``maxpool2d``'s,
    5b's stride-1 max pool ``maxpool2d_s1``'s: on the CPU each wrapper
    runs its plain version and counts nothing."""
    m = inception.Inception_v2(1000, device="meta")
    pools = [p for p in m.modules() if isinstance(p, nn.SpatialMaxPooling)]
    assert [(p.dw, p.pad_w, p.ceil_mode) for p in pools] == [
        (2, 0, True), (2, 0, True), (2, 0, True), (2, 0, True),
        (1, 1, True)]
    avg = [p for p in m.modules() if isinstance(p, nn.SpatialAveragePooling)]
    assert len(avg) == 8 and all(p.ceil_mode for p in avg[:-1])


@pytest.mark.parametrize("name", ["AlexNet", "AlexNet_OWT"])
def test_alexnet_log_probs_and_grads_match_jax(name, mosaic_pools):
    set_seed(4)
    jm = getattr(jax_alexnet, name)(10)
    pm = getattr(alexnet, name)(10, device="cpu")
    load_jax_params(pm, _np(jm.params()))
    for m in list(pm.modules()):
        if isinstance(m, nn.Dropout):
            m.set_p(0.0)
    stack = [jm]
    while stack:
        mod = stack.pop()
        if isinstance(mod, jnn.Dropout):
            mod.set_p(0.0)
        stack += list(mod._modules.values())
    rs = np.random.RandomState(5)
    x = (rs.randn(2, 3, 227, 227) * 50).astype(np.float32)
    y = np.asarray([3.0, 7.0], np.float32)
    ops.reset_launch_counts()
    _log_probs_and_grads(jm, pm, x, y)
    assert set(ops.launch_counts().values()) == {0}


def test_autoencoder_matches_jax():
    set_seed(6)
    jm = jax_autoencoder.Autoencoder(32)
    pm = load_jax_params(autoencoder.Autoencoder(32, device="cpu"),
                         _np(jm.params()))
    rs = np.random.RandomState(7)
    x = rs.uniform(0, 1, (4, 28, 28)).astype(np.float32)

    def mse(p):
        out, _ = jm.apply(p, jnp.asarray(x), jm.state(), Context(True))
        return jnp.mean((out - jnp.asarray(x).reshape(4, -1)) ** 2), out

    (loss_j, out_j), grads_j = jax.value_and_grad(mse, has_aux=True)(
        jm.params())
    out = pm(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(x).reshape(4, -1)) ** 2).mean()
    loss.backward()
    assert tuple(out.shape) == (4, 784)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)


@pytest.mark.parametrize("build", [
    lambda: inception.Inception_v2(1000), lambda: alexnet.AlexNet(1000),
    lambda: alexnet.AlexNet_OWT(1000), lambda: autoencoder.Autoencoder(32),
])
def test_entry_points_default_to_the_card(build):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
