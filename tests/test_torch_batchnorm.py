"""The port's batch normalisation and module state against the JAX
package: ``BatchNormalization`` / ``SpatialBatchNormalization``
forward in training and in evaluation, dx, dγ and dβ, the running
statistics after k steps (one value a channel and the unbatched input
among them), the golden cases, and the state tree (``state``,
``load_state`` in place, ``copy_status``, ``export_state`` /
``load_jax_state``, the module files of either package).

Weights and state cross from the JAX module through the tree carriers;
inputs come from numpy seeds.  Forward and gradients are held at rtol
1e-4 / atol 1e-5 (fp32 sums in another order), as the other parity tests
of the port are."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Context
from bigdl_tpu.utils import file as JaxFile
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils.random import generator

TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")

# (class, constructor arguments, input shape): a (N, D) batch, one value a
# channel (n = 1), the unbatched (D,) sample, a (N, D, L) input (statistics
# over N and L), NCHW, one CHW sample, eps / momentum given positionally,
# and affine off
CASES = [
    ("BatchNormalization", (6,), (8, 6)),
    ("BatchNormalization", (6,), (1, 6)),
    ("BatchNormalization", (6,), (6,)),
    ("BatchNormalization", (4, 1e-3, 0.3), (5, 4, 7)),
    ("SpatialBatchNormalization", (3,), (4, 3, 5, 6)),
    ("SpatialBatchNormalization", (3, 1e-3), (3, 5, 6)),
    ("SpatialBatchNormalization", (3,), (1, 3, 1, 1)),
    ("SpatialBatchNormalization", (5, 1e-5, 0.1, False), (2, 5, 3, 3)),
]


def _pair(name, args, seed=0):
    """The JAX module (weights from ``set_seed``) and the port's, loaded
    from its trees, with non-trivial running statistics."""
    set_seed(seed)
    jm = getattr(jnn, name)(*args)
    rs = np.random.RandomState(seed + 100)
    c = args[0]
    state = {"~": {"running_mean": rs.randn(c).astype(np.float32),
                   "running_var": rs.uniform(0.5, 2, c).astype(np.float32)}}
    jm.load_state(state)
    if jm.affine:   # a non-zero bias
        jm.load_params({"~": {"weight": np.asarray(jm.params()["~"]["weight"]),
                              "bias": rs.randn(c).astype(np.float32)}})
    pm = getattr(nn, name)(*args, device="cpu")
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.params()))
    load_jax_state(pm, state)
    return jm, pm


def _jax_step(jm, params, state, x, g, training):
    """y, the new state, and the gradients of <y, g> wrt params and x."""
    ctx = Context(training=training)

    def f(p, v):
        return jm.apply(p, v, state, ctx)

    (y, new_state), vjp = jax.vjp(f, params, jnp.asarray(x))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, new_state)
    dp, dx = vjp((jnp.asarray(g), zeros))
    return y, new_state, dp, dx


def _own(tree):
    return {k: np.asarray(v) for k, v in tree["~"].items()}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name,args,shape", CASES)
def test_forward_and_gradients_match_jax(name, args, shape, training):
    jm, pm = _pair(name, args)
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    y_j, state_j, dp_j, dx_j = _jax_step(jm, jm.params(), jm.state(), x, g,
                                         training)
    pm.train(training)
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(dp_j["~"][k]), **TOL)
    assert set(k for k, _ in pm.named_parameters()) == set(dp_j["~"])
    for k, v in _own(state_j).items():
        np.testing.assert_allclose(getattr(pm, k).numpy(), v, **TOL)


@pytest.mark.parametrize("name,args,shape", CASES)
def test_running_statistics_after_k_steps_match_jax(name, args, shape):
    """Three training steps on three batches, then an evaluation forward
    that reads the statistics they left."""
    jm, pm = _pair(name, args, seed=2)
    rs = np.random.RandomState(3)
    state = jm.state()
    pm.train()
    for _ in range(3):
        x = (rs.randn(*shape) * 2 - 0.5).astype(np.float32)
        _, state = jm.apply(jm.params(), jnp.asarray(x), state,
                            Context(training=True))
        with torch.no_grad():
            pm(torch.from_numpy(x))
    for k, v in _own(state).items():
        np.testing.assert_allclose(getattr(pm, k).numpy(), v, **TOL)
    x = rs.randn(*shape).astype(np.float32)
    y_j, _ = jm.apply(jm.params(), jnp.asarray(x), state,
                      Context(training=False))
    pm.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(y_j), **TOL)


@pytest.mark.parametrize("seed", range(8))
def test_one_value_a_channel_follows_jax(seed):
    """F.batch_norm refuses one value a channel in training; the JAX
    module gives variance 0, divides by max(n - 1, 1) and decays the
    running variance.  The output is held to the JAX module's on the same
    weight and bias: both compute ``x·scale + shift``, two terms of about
    |x|·|w|/sqrt(eps) (~2,000 here) that cancel to the bias, so one
    float32 rounding of them (a fused multiply-add on one side and not
    the other) moves the result by an ulp of that size; the bound is 4
    ulps of the largest |x·scale|."""
    bn = nn.BatchNormalization(3, device="cpu", generator=generator(seed))
    bias = np.asarray([0.5, -1.0, 2.0], np.float32)
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(bias))
    x = torch.tensor([[4.0, -2.0, 7.0]])
    y = bn(x)
    jm = jnn.BatchNormalization(3)
    weight = bn.weight.detach().numpy().copy()
    jm.load_params({"~": {"weight": weight, "bias": bias}})
    y_j, _ = jm.apply(jm.params(), jnp.asarray(x.numpy()), jm.state(),
                      Context(training=True))
    terms = np.abs(x.numpy()[0].astype(np.float64) * weight) / np.sqrt(bn.eps)
    bound = 4 * float(np.spacing(np.float32(terms.max())))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=0,
                               atol=bound)
    torch.testing.assert_close(bn.running_mean, 0.1 * x[0])
    torch.testing.assert_close(bn.running_var, torch.full((3,), 0.9))


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="no golden fixtures")
@pytest.mark.parametrize("case", ["batchnorm_train", "spatial_bn_eval",
                                  "batchnorm_eval"])
def test_golden_cases(case):
    """tests/golden/golden.npz: the JAX module built under set_seed(1234)
    (its weight draw carried across) on the generator's inputs."""
    want = np.load(GOLDEN)[case]
    x24 = np.random.RandomState(7).randn(2, 4).astype(np.float32)
    x_img = np.random.RandomState(8).randn(2, 3, 8, 8).astype(np.float32)
    name, c, x, training = {
        "batchnorm_train": ("BatchNormalization", 4, x24, True),
        "batchnorm_eval": ("BatchNormalization", 4, x24, False),
        "spatial_bn_eval": ("SpatialBatchNormalization", 3, x_img, False),
    }[case]
    set_seed(1234)
    jm = getattr(jnn, name)(c)
    pm = load_jax_params(getattr(nn, name)(c, device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jm.params()))
    pm.train(training)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weight_is_drawn_uniform_from_the_generator():
    a = nn.SpatialBatchNormalization(4096, device="cpu",
                                     generator=generator(3))
    b = nn.SpatialBatchNormalization(4096, device="cpu",
                                     generator=generator(3))
    w = a.weight.detach()
    assert torch.equal(w, b.weight.detach())
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    assert abs(float(w.mean()) - 0.5) < 0.02
    assert torch.equal(a.bias.detach(), torch.zeros(4096))
    assert torch.equal(a.running_mean, torch.zeros(4096))
    assert torch.equal(a.running_var, torch.ones(4096))
    assert nn.BatchNormalization(3, 1e-3, 0.2, False).weight is None


def _model(device="cpu", seed=0):
    g = generator(seed)
    return nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, device=device, generator=g),
        nn.SpatialBatchNormalization(4, device=device, generator=g),
        nn.ReLU(),
        nn.Sequential(nn.View(4 * 3 * 3), nn.Linear(36, 5, device=device,
                                                    generator=g),
                      nn.BatchNormalization(5, device=device, generator=g)))


def _jax_model():
    return jnn.Sequential(
        jnn.SpatialConvolution(3, 4, 3, 3), jnn.SpatialBatchNormalization(4),
        jnn.ReLU(),
        jnn.Sequential(jnn.View(4 * 3 * 3), jnn.Linear(36, 5),
                       jnn.BatchNormalization(5)))


def test_state_tree_is_the_jax_layout():
    """Buffers under the JAX names only (no ``num_batches_tracked``), in
    the nested ``{'~', '<i>'}`` layout with every module present."""
    set_seed(4)
    jm = _jax_model()
    pm = _model()
    want = jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jm.state()))
    got = export_state(pm)
    assert jax.tree_util.tree_structure(got) == want
    assert list(got["1"]["~"]) == ["running_mean", "running_var"]
    assert got["0"] == {"~": {}} and got["3"]["2"]["~"]["running_var"].shape \
        == (5,)
    assert [k for k, _ in pm.named_buffers()] == [
        "1.running_mean", "1.running_var", "3.2.running_mean",
        "3.2.running_var"]


def test_load_state_copies_in_place_and_round_trips():
    pm = _model()
    ptrs = [b.data_ptr() for b in pm.buffers()]
    rs = np.random.RandomState(5)
    tree = jax.tree_util.tree_map(
        lambda v: rs.randn(*v.shape).astype(np.float32), export_state(pm))
    assert load_jax_state(pm, tree) is pm
    assert [b.data_ptr() for b in pm.buffers()] == ptrs
    for a, b in zip(jax.tree_util.tree_leaves(export_state(pm)),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # a JAX module takes the port's tree, and the port the JAX module's
    jm = _jax_model()
    jm.load_state(export_state(pm))
    other = _model(seed=1)
    other.load_state(jax.tree_util.tree_map(np.asarray, jm.state()))
    for a, b in zip(other.buffers(), pm.buffers()):
        assert torch.equal(a, b)
    # copy_status: the running state of another module of the same shape
    fresh = _model(seed=2)
    fresh.copy_status(pm)
    for a, b in zip(fresh.buffers(), pm.buffers()):
        assert torch.equal(a, b)
    assert not torch.equal(fresh.get(2).weight, pm.get(2).weight)


def test_load_state_refuses_a_missing_or_misshapen_buffer():
    pm = _model()
    tree = export_state(pm)
    del tree["1"]["~"]["running_var"]
    with pytest.raises(KeyError, match="running_var"):
        pm.load_state(tree)
    tree = export_state(pm)
    tree["3"]["2"]["~"]["running_mean"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape"):
        pm.load_state(tree)
    tree = export_state(pm)
    del tree["3"]
    with pytest.raises(KeyError, match="state subtree"):
        pm.load_state(tree)


def test_module_files_carry_the_state_both_ways(tmp_path):
    """utils/file.py writes and reads the JAX ``state()`` layout: a JAX
    module file fills the port's buffers, a port file the JAX module's."""
    set_seed(6)
    jm = _jax_model()
    rs = np.random.RandomState(7)
    jm.load_state(jax.tree_util.tree_map(
        lambda v: rs.uniform(0.5, 2, np.shape(v)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.state())))
    JaxFile.save_module(jm, str(tmp_path / "jax.model"))
    pm = File.load_module_into(_model(seed=8), str(tmp_path / "jax.model"))
    for a, b in zip(jax.tree_util.tree_leaves(export_state(pm)),
                    jax.tree_util.tree_leaves(jm.state())):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(export_params(pm)),
                    jax.tree_util.tree_leaves(jm.params())):
        np.testing.assert_array_equal(a, np.asarray(b))
    with torch.no_grad():
        for b in pm.buffers():
            b.mul_(3.0)
    File.save_module(pm, str(tmp_path / "port.model"))
    jback = JaxFile.load_module_into(_jax_model(), str(tmp_path / "port.model"))
    for a, b in zip(jax.tree_util.tree_leaves(jback.state()),
                    jax.tree_util.tree_leaves(export_state(pm))):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = File.load_module(str(tmp_path / "port.model"), device="cpu")
    for a, b in zip(again.buffers(), pm.buffers()):
        assert torch.equal(a, b)
