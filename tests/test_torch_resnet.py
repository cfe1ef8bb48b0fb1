"""The port's ResNet slice against the JAX package: the full
``ResNet(50)`` and ``ResNetCifar(20)`` parameter and state trees (no
forward), the final-BN zero init (16 of ResNet-50's 53 weights in the
port, 20 in the JAX model, whose rule also zeroes the projection
shortcuts' BN), ``ResNetCifar(8)`` with type-A and type-B shortcuts and a
``bottleneck`` block forward and backward in training and evaluation, a
short ``LocalOptimizer`` run with examples/train_resnet.py's SGD state
(nesterov, dampening 0, ``EpochStep(81, 0.1)``) and the eager chunk of n
= 2 and 3 steps a dispatch against the JAX chunk, losses, parameters and
running statistics alike; the MSRA init and ``MulConstant``.

Weights and state cross from the JAX model through the tree carriers;
the zeroed weights of the tree are replaced by U(0, 1) draws first (with
them zero, each residual branch's gradients are zero and the checks
would hold little).  Held at rtol 1e-4 / atol 1e-5."""
import math

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
from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu.nn.module import Context
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim.optim_method import EpochStep as JaxEpochStep
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, cifar)
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn.module import (export_params, export_state,
                                       load_jax_params, load_jax_state)
from bigdl_tpu_torch.optim import EpochStep, LocalOptimizer, max_iteration
from bigdl_tpu_torch.utils.random import generator
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-4, atol=1e-5)


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


def _zeroed(tree):
    """The paths of the all-zero BN weights of a parameter tree."""
    return [k for k, v in jax.tree_util.tree_leaves_with_path(_np(tree))
            if k[-1].key == "weight" and np.ndim(v) == 1 and not np.any(v)]


def _ungated(tree, seed=0):
    """``tree`` with each all-zero BN weight drawn U(0, 1)."""
    rs = np.random.RandomState(seed)

    def fill(path, v):
        v = np.asarray(v)
        if path[-1].key == "weight" and v.ndim == 1 and not v.any():
            return rs.uniform(0, 1, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.mark.parametrize("build,n_params,n_leaves,n_bn", [
    (lambda pkg, **d: pkg.ResNet(50, 1000, **d), 25557032, 161, 53),
    (lambda pkg, **d: pkg.ResNetCifar(20, 10, **d), 269722, 59, 19),
    (lambda pkg, **d: pkg.ResNetCifar(8, 10, "B", **d), 78042, 29, 9),
])
def test_full_model_trees_carry_across(build, n_params, n_leaves, n_bn):
    set_seed(1)
    jm = build(jax_resnet)
    pm = build(resnet, device="cpu")
    assert _shapes(export_params(pm)) == _shapes(jm.params())
    assert _shapes(export_state(pm)) == _shapes(jm.state())
    assert len(jax.tree_util.tree_leaves(export_params(pm))) == n_leaves
    assert sum(p.numel() for p in pm.parameters()) == n_params
    assert sum(isinstance(m, nn.SpatialBatchNormalization)
               for m in pm.modules()) == n_bn
    load_jax_params(pm, _np(jm.params()))
    _assert_trees_close(export_params(pm), jm.params(), rtol=0, atol=0)


def test_zero_init_counts_16_in_the_port_and_20_in_jax():
    """The JAX rule zeroes the last BN of every Sequential, the type-B
    projection shortcut's (``/k/0/0/1/1``) included; the port zeroes the
    residual branches' only (ResNet.scala's intent)."""
    set_seed(2)
    jz = _zeroed(jax_resnet.ResNet(50).params())
    pz = _zeroed(export_params(resnet.ResNet(50, device="cpu",
                                             generator=generator(0))))
    assert len(jz) == 20 and len(pz) == 16
    assert set(pz) < set(jz)
    shortcut_bns = set(jz) - set(pz)
    assert all(jax.tree_util.keystr(k).endswith("['1']['1']['~']['weight']")
               for k in shortcut_bns)
    # ResNetCifar's type-A shortcuts hold no BN: both zero the 9 branches
    assert len(_zeroed(jax_resnet.ResNetCifar(20).params())) == 9
    m = resnet.ResNetCifar(20, device="cpu")
    assert len(_zeroed(export_params(m))) == 9
    assert resnet._zero_init_final_bn(m) == 9


def _pair(build, seed):
    set_seed(seed)
    jm = build(jax_resnet)
    tree = _ungated(jm.params(), seed)
    jm.load_params(tree)
    pm = build(resnet, device="cpu")
    load_jax_params(pm, tree)
    load_jax_state(pm, _np(jm.state()))
    return jm, pm


@pytest.mark.parametrize("shortcut", ["A", "B", "C"])
def test_resnet_cifar8_log_probs_grads_and_state_match_jax(shortcut):
    jm, pm = _pair(lambda pkg, **d: pkg.ResNetCifar(8, 10, shortcut, **d), 3)
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 3, 32, 32) * 2).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.float32)
    crit = jnn.ClassNLLCriterion()

    def loss_fn(p):
        out, st = jm.apply(p, jnp.asarray(x), jm.state(),
                           Context(training=True))
        return crit.apply_loss(out, jnp.asarray(y)), (out, st)

    (loss_j, (out_j, state_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(jm.params())
    out = pm(torch.from_numpy(x))
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    _assert_trees_close(_grads(pm), grads_j, **TOL)
    _assert_trees_close(export_state(pm), state_j, **TOL)
    want, _ = jm.apply(jm.params(), jnp.asarray(x), state_j,
                       Context(training=False))
    pm.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("n_in,n_mid,stride", [(8, 4, 2), (16, 4, 1)])
def test_bottleneck_block_matches_jax(n_in, n_mid, stride):
    """ResNet-50's block: 1x1, 3x3 (strided), 1x1 with BN, and the type-B
    projection where the shape changes (an identity where it does not)."""
    jm, pm = _pair(lambda pkg, **d: pkg.bottleneck(n_in, n_mid, stride,
                                                   **d), 5)
    rs = np.random.RandomState(6)
    x = rs.randn(2, n_in, 9, 9).astype(np.float32)
    ctx = Context(training=True)
    (y_j, state_j), vjp = jax.vjp(
        lambda p, v: jm.apply(p, v, jm.state(), ctx), jm.params(),
        jnp.asarray(x))
    g = rs.randn(*y_j.shape).astype(np.float32)
    dp_j, dx_j = vjp((jnp.asarray(g),
                      jax.tree_util.tree_map(jnp.zeros_like, state_j)))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    _assert_trees_close(_grads(pm), dp_j, **TOL)
    _assert_trees_close(export_state(pm), state_j, **TOL)


SGD_STATE = dict(learningRate=0.1, momentum=0.9, weightDecay=1e-4,
                 dampening=0.0, nesterov=True)


def _run_pair(seed, steps, n, n_images, epoch_step=EpochStep):
    """The JAX and the port ResNetCifar(8) trained ``steps`` iterations,
    n a dispatch, over ``n_images`` synthetic CIFAR images in batches of
    4 (one epoch: the JAX transformers rewrite the records they pass),
    examples/train_resnet.py's chain and SGD state."""
    jm, pm = _pair(lambda pkg, **d: pkg.ResNetCifar(8, 10, **d), seed)
    norm = (cifar.TRAIN_MEAN, cifar.TRAIN_STD)
    jds = (JaxDataSet.array(jax_cifar.synthetic(n_images, 7))
           >> JaxNormalizer(*norm) >> JaxCropper(32, 32, padding=4)
           >> JaxHFlip() >> JaxToBatch(4))
    jopt = JaxLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_state(JaxT(**SGD_STATE,
                        learningRateSchedule=JaxEpochStep(81, 0.1)))
    jopt.set_end_when(jax_max_iteration(steps))
    jopt.set_iterations_per_dispatch(n)
    set_seed(8)
    jopt.optimize()
    pds = (DataSet.array(cifar.synthetic(n_images, 7), seed=8)
           >> ImgNormalizer(*norm) >> ImgRdmCropper(32, 32, padding=4)
           >> HFlip() >> ImgToBatch(4))
    popt = LocalOptimizer(pm, pds, nn.ClassNLLCriterion(), device="cpu")
    popt.set_state(T(**SGD_STATE, learningRateSchedule=epoch_step(81, 0.1)))
    popt.set_end_when(max_iteration(steps))
    popt.set_iterations_per_dispatch(n)
    popt.optimize()
    return jopt, popt


def _assert_runs_equal(jopt, popt, steps):
    assert popt.state["neval"] == jopt.state["neval"] == steps + 1
    np.testing.assert_allclose(popt.state["loss"], jopt.state["loss"], **TOL)
    _assert_trees_close(export_params(popt.model), jopt.model.params(), **TOL)
    _assert_trees_close(export_state(popt.model), jopt.model.state(), **TOL)


def test_local_optimizer_trajectory_matches_jax():
    jopt, popt = _run_pair(9, 4, 1, 16)
    _assert_runs_equal(jopt, popt, 4)
    losses = [l for _, l in popt.loss_log]
    assert len(losses) == 4 and np.isfinite(losses).all()
    # the statistics moved: 4 EMA steps of momentum 0.1 from (0, 1)
    rm = popt.model.get(2).running_mean
    assert float(rm.abs().max()) > 0.01


@pytest.mark.parametrize("n", [2, 3])
def test_eager_chunk_with_state_matches_the_jax_chunk(n):
    """n steps a dispatch (the JAX ``lax.scan`` chunk; an eager loop on
    the CPU): six steps of an epoch of 32 images."""
    jopt, popt = _run_pair(10, 6, n, 32)
    _assert_runs_equal(jopt, popt, 6)
    assert len(popt.loss_log) == 6


def test_a_non_finite_step_keeps_the_running_statistics():
    """The JAX step keeps params, velocity and state where the step is
    not finite (``_where_finite``); so does the port's."""
    pm = resnet.ResNetCifar(8, 10, device="cpu", generator=generator(1))
    recs = cifar.synthetic(8, 3)
    recs[4].data[0, 0, 0] = np.nan   # the second batch
    ds = DataSet.array(recs, seed=1) >> ImgToBatch(4)
    opt = LocalOptimizer(pm, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.1)).set_end_when(max_iteration(1))
    opt.optimize()
    before = [b.clone() for b in pm.buffers()]
    params = [p.detach().clone() for p in pm.parameters()]
    opt.set_end_when(max_iteration(2)).optimize()
    assert opt.state["nonFiniteSkips"] == 1
    for a, b in zip(pm.buffers(), before):
        assert torch.equal(a, b)
    for a, b in zip(pm.parameters(), params):
        assert torch.equal(a.detach(), b)


def test_the_buffer_snapshot_is_allocated_once_a_run():
    """The pre-step copy of the running statistics is made once for a set
    of buffers and refilled in place at every step; buffers that move
    (a resumed model's, another device's) get a new one."""
    pm = resnet.ResNetCifar(8, 10, device="cpu", generator=generator(1))
    ds = DataSet.array(cifar.synthetic(12, 3), seed=1) >> ImgToBatch(4)
    opt = LocalOptimizer(pm, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_state(T(learningRate=0.1)).set_end_when(max_iteration(1))
    opt.optimize()
    kept = opt._kept
    (_, saved, _, _), = kept.groups   # one dtype
    ptr = saved.data_ptr()
    opt.set_end_when(max_iteration(3)).optimize()
    assert opt._kept is kept and saved.data_ptr() == ptr
    # the copy holds the buffers as they were before the last step
    first = next(m for m in pm.modules()
                 if isinstance(m, nn.SpatialBatchNormalization))
    assert not torch.equal(saved[:first.n_output], first.running_mean)
    pm.load_state(export_state(pm))   # in place: the same snapshot
    opt.set_end_when(max_iteration(4)).optimize()
    assert opt._kept is kept
    first.running_mean = first.running_mean.clone()   # rebound
    opt.set_end_when(max_iteration(5)).optimize()
    assert opt._kept is not kept


def test_msra_init_draws_he_normal():
    conv = nn.SpatialConvolution(64, 128, 3, 3, init_method=nn.MSRA,
                                 with_bias=False, device="cpu",
                                 generator=generator(0))
    w = conv.weight.detach()
    want = math.sqrt(2.0 / (3 * 3 * 128))
    assert abs(float(w.std()) / want - 1) < 0.02
    assert abs(float(w.mean())) < 0.02 * want
    assert conv.bias is None
    again = nn.SpatialConvolution(64, 128, 3, 3, init_method=nn.MSRA,
                                  generator=generator(0))
    assert torch.equal(again.weight.detach(), w)
    assert torch.equal(again.bias.detach(), torch.zeros(128))
    set_seed(0)
    jw = np.asarray(jnn.SpatialConvolution(
        64, 128, 3, 3, init_method=jnn.MSRA).params()["~"]["weight"])
    assert abs(jw.std() / want - 1) < 0.02


def test_mul_constant_matches_jax():
    x = np.random.RandomState(11).randn(2, 3, 4).astype(np.float32)
    for c in (0.0, -2.5):
        np.testing.assert_array_equal(
            nn.MulConstant(c)(torch.from_numpy(x)).numpy(),
            np.asarray(jnn.MulConstant(c).forward(jnp.asarray(x))))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for build in (resnet.ResNet, resnet.ResNetCifar):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
