"""The port's max pool (bigdl_tpu_torch/ops/maxpool.py and
``nn.SpatialMaxPooling``) against the JAX package's Mosaic pool
``mosaic_maxpool2d`` in interpret mode, as tests/test_pallas_ops.py's
``TestMosaicMaxPool`` runs it: output, the stored window argmax and the
gradient, on that test's six geometries and Inception-v1's four 3x3 s2
pools with quantized inputs, so that ties occur and the first-max rule
decides where the gradient goes.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn import pooling as jax_pooling
from bigdl_tpu.nn.module import Context
from bigdl_tpu.ops.pallas_kernels import _mosaic_mp_fwd_call, mosaic_maxpool2d
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.nn import SpatialMaxPooling

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [   # tests/test_pallas_ops.py TestMosaicMaxPool.CASES
    ((2, 5, 13, 17), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 3, 10, 12), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 4, 9, 11), (2, 2), (2, 2), ((0, 1), (1, 0))),
    ((1, 2, 12, 8), (5, 3), (3, 2), ((2, 2), (1, 1))),
    ((37, 1, 13, 7), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((1, 100, 8, 8), (3, 3), (1, 1), ((0, 0), (0, 0))),
]
# Inception-v1's four 3x3 s2 ceil pools (models/inception.py): inputs of
# 112, 56, 28 and 14 a side, at N = 1 and a few channels
INCEPTION_CASES = [
    ((1, 2, 112, 112), (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((1, 3, 56, 56), (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((1, 4, 28, 28), (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((1, 5, 14, 14), (3, 3), (2, 2), ((0, 1), (0, 1))),
]


def _quantized(rs, shape):
    return (np.round(rs.randn(*shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("shape,win,st,pads", CASES + INCEPTION_CASES)
def test_forward_argmax_grad_match_mosaic(shape, win, st, pads):
    rs = np.random.RandomState(0)
    x = _quantized(rs, shape)
    y_jax, a_jax = _mosaic_mp_fwd_call(jnp.asarray(x), win, st, pads,
                                       interpret=True, with_argmax=True)
    # the JAX argmax lives in the kernel's padded NHWC frame
    a_jax = np.asarray(a_jax)[:, :y_jax.shape[2]].transpose(0, 3, 1, 2)
    g = rs.randn(*y_jax.shape).astype(np.float32)
    d_jax = jax.grad(lambda v: (mosaic_maxpool2d(v, win, st, pads, True)
                                * g).sum())(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = ops.maxpool2d(xt, win, st, pads)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    _, arg = ops.maxpool2d_forward(torch.from_numpy(x), win, st, pads)
    assert arg.dtype == torch.int32
    np.testing.assert_array_equal(arg.numpy(), a_jax)


@pytest.mark.parametrize("shape,win,st,pads", [CASES[0], CASES[2], CASES[5]])
def test_nan_rule_matches_mosaic(shape, win, st, pads):
    """NaN inputs: a NaN at a window's first tap is the window's output
    (argmax 0), a NaN at a later tap never wins, as in the Mosaic kernel;
    the gradient follows the same argmax."""
    rs = np.random.RandomState(7)
    x = _quantized(rs, shape)
    x[rs.rand(*shape) < 0.15] = np.nan
    y_jax, a_jax = _mosaic_mp_fwd_call(jnp.asarray(x), win, st, pads,
                                       interpret=True, with_argmax=True)
    a_jax = np.asarray(a_jax)[:, :y_jax.shape[2]].transpose(0, 3, 1, 2)
    g = rs.randn(*y_jax.shape).astype(np.float32)
    d_jax = jax.grad(lambda v: (mosaic_maxpool2d(v, win, st, pads, True)
                                * g).sum())(jnp.asarray(x))

    y, arg = ops.maxpool2d_forward(torch.from_numpy(x), win, st, pads)
    assert np.isnan(np.asarray(y_jax)).any()
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_jax))
    np.testing.assert_array_equal(arg.numpy(), a_jax)
    xt = torch.from_numpy(x).requires_grad_()
    (ops.maxpool2d(xt, win, st, pads) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)


@pytest.mark.parametrize("shape,win,st,pads", CASES + INCEPTION_CASES)
def test_plain_backward_equals_autograd_of_plain_forward(shape, win, st,
                                                         pads):
    """The gather backward (from the argmax alone) equals autograd
    through the unfold/argmax/gather forward: the same first-max
    routing."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(_quantized(rs, shape)).requires_grad_()
    y, arg = ops.maxpool2d_forward_reference(x, win, st, pads)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    (y * g).sum().backward()
    dx = ops.maxpool2d_backward(arg, g, win, st, pads, tuple(shape))
    torch.testing.assert_close(dx, x.grad, **TOL)


@pytest.mark.parametrize("kw,kh,dw,dh,pw,ph,ceil,shape", [
    (2, 2, 2, 2, 0, 0, False, (3, 6, 24, 24)),    # LeNet's pools, with ties
    (3, 3, 2, 2, 1, 1, True, (2, 6, 14, 14)),     # test_pallas_ops's module
    (3, 3, 2, 2, 0, 0, True, (2, 4, 15, 15)),     # Inception's first pool
    (3, 3, 1, 1, 1, 1, False, (1, 3, 7, 9)),      # in-block, stride 1
])
def test_module_matches_jax_module(monkeypatch, kw, kh, dw, dh, pw, ph, ceil,
                                   shape):
    """``SpatialMaxPooling`` against the JAX module routed through its
    Mosaic kernel (``_PALLAS_POOL = "interpret"``, the first-max rule;
    its default route for non-overlapping pools splits ties), output and
    gradient, 3D input included."""
    monkeypatch.setattr(jax_pooling, "_PALLAS_POOL", "interpret")
    rs = np.random.RandomState(2)
    x = _quantized(rs, shape)
    jm = jax_pooling.SpatialMaxPooling(kw, kh, dw, dh, pw, ph)
    pm = SpatialMaxPooling(kw, kh, dw, dh, pw, ph)
    if ceil:
        jm, pm = jm.ceil(), pm.ceil()
    y_jax = np.asarray(jm.forward(jnp.asarray(x)))
    g = rs.randn(*y_jax.shape).astype(np.float32)
    ctx = Context(training=True)
    d_jax = jax.grad(lambda v: (jm.apply({"~": {}}, v, {"~": {}}, ctx)[0]
                                * g).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), y_jax)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_jax), **TOL)
    y3 = pm(torch.from_numpy(x[0]))
    np.testing.assert_array_equal(y3.numpy(), y_jax[0])


def test_no_grad_forward_equals_grad_forward():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(_quantized(rs, (2, 5, 13, 17)))
    win, st, pads = (3, 3), (2, 2), ((1, 1), (1, 1))
    y_grad = ops.maxpool2d(x.clone().requires_grad_(), win, st, pads)
    with torch.no_grad():
        y_nograd = ops.maxpool2d(x.clone().requires_grad_(), win, st, pads)
    y_plain = ops.maxpool2d(x, win, st, pads)   # no tensor needs a grad
    assert y_grad.requires_grad and not y_nograd.requires_grad
    assert torch.equal(y_grad.detach(), y_nograd)
    assert torch.equal(y_plain, y_nograd)
    y_only = ops.maxpool2d_forward(x, win, st, pads, with_argmax=False)
    assert torch.equal(y_only, y_plain)


def test_cpu_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(1, 2, 6, 6, requires_grad=True)
    ops.maxpool2d(x, (2, 2), (2, 2), ((0, 0), (0, 0))).sum().backward()
    counts = ops.launch_counts()
    assert counts["maxpool2d_forward"] == counts["maxpool2d_backward"] == 0


def test_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU never reaches a plain version: each
    wrapper launches its kernel or raises."""
    x = torch.empty(1, 2, 6, 6, device="meta")
    pads = ((0, 0), (0, 0))
    with pytest.raises(ValueError, match="no kernel"):
        ops.maxpool2d_forward(x, (2, 2), (2, 2), pads)
    g = torch.empty(1, 2, 3, 3, device="meta")
    arg = torch.empty(1, 2, 3, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.maxpool2d_backward(arg, g, (2, 2), (2, 2), pads, (1, 2, 6, 6))


def test_window_larger_than_frame_raises():
    with pytest.raises(ValueError, match="does not fit"):
        ops.maxpool2d_forward(torch.zeros(1, 1, 2, 2), (3, 3), (1, 1),
                              ((0, 0), (0, 0)))
